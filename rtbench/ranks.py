"""A cell on several cards: one rank process a card, steps in lockstep, and
the report of the cards a run really used.

`launch` starts the command once a rank, with torchrun's variables
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR`` 127.0.0.1 and a free ``MASTER_PORT``), passes rank 0's
result line on only when every rank ends with 0, and ends every rank once
one fails.  Each rank calls `join` before anything touches a card: its card
(``LOCAL_RANK``) becomes the current device and the default process group
starts (NCCL on the card, gloo on the CPU), so the program's own
`multihost.initialize` and `dist.make_mesh` find it as under torchrun.

The harness's own exchanges (`Group.agree`, `Group.gather`) go over a star
of local socket pairs that the launcher makes, rank 0 at its centre: they
allocate nothing on a card, launch nothing there and stay out of its trace,
and a rank that ends closes its socket, so its peers fail at once.  On the
host of four H100s a step's exchange took 0.12-0.13 ms (median), a 4-byte
gloo all-reduce 0.71-1.02 ms, a NCCL one read back 0.07 ms, but NCCL puts a
kernel and a copy in every step and a tensor on every card, which would
hide an idle one.

Every rank reports its card, the card's peak of allocated memory and its
name (`report`); `device_line` makes the line's ``device`` from the
reports, and `hold` refuses a run that left a card idle or loaded a
forbidden module.
"""
from __future__ import annotations

import collections
import ctypes
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from datetime import timedelta

import torch
import torch.distributed as tdist

# Every collective of the program's group (NCCL) and every wait of the
# harness's exchanges: far above a step (milliseconds to a second) and the
# ranks' skew at the end of set-up (their kernels build side by side), far
# below a run's limit.
GROUP_TIMEOUT_S = 120
# After a rank fails, the others get this long to end by themselves before
# they are ended: a rank that finds a fault the others share exits too.
GRACE_S = 5.0
# The exit codes of a refused run (2: too few cards, in `rtbench.run`).
FORBIDDEN_EXIT = 3
IDLE_EXIT = 4
# The command's start (`time.perf_counter`, the host's monotonic clock,
# which every process of the host reads alike), the launcher's process id
# and the rank's ends of the socket pairs, handed to each rank.  A process
# with ``RTBENCH_T0`` is a rank.
T0_VAR = "RTBENCH_T0"
LAUNCHER_VAR = "RTBENCH_LAUNCHER"
LINKS_VAR = "RTBENCH_LINKS"
TAIL_BYTES = 16384
PR_SET_PDEATHSIG = 1


class Refused(RuntimeError):
    """A run that may print no result; ``code`` is its exit code."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


def is_rank() -> bool:
    return T0_VAR in os.environ


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _drain(stream, keep: collections.deque):
    for chunk in iter(lambda: stream.read1(4096), b""):
        keep.append(chunk)
    stream.close()


def _end_on_signal(signum, _frame):
    raise SystemExit(128 + signum)


def launch(cmd: list[str], world: int, t0: float) -> int:
    """Run ``cmd`` as ranks 0 to ``world`` - 1 of one group and wait for all.
    Rank 0's standard error passes through as it comes; its standard output
    is held, and written out only when every rank ends with 0.  Once a rank
    fails, the others get `GRACE_S` to end, then are ended; the failing
    ranks' last output follows on standard error.  Returns rank 0's exit
    code where rank 0 ended by itself, else the lowest failing rank's."""
    base = dict(os.environ, WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                **{T0_VAR: repr(t0), LAUNCHER_VAR: str(os.getpid())})
    procs, outs, readers, ended = [], [], [], set()
    pairs = [socket.socketpair() for _ in range(world - 1)]  # rank 0 to rank k + 1
    previous = signal.signal(signal.SIGTERM, _end_on_signal)
    try:
        for r in range(world):
            links = [a.fileno() for a, _ in pairs] if r == 0 else [pairs[r - 1][1].fileno()]
            env = dict(base, RANK=str(r), LOCAL_RANK=str(r),
                       **{LINKS_VAR: ",".join(map(str, links))})
            p = subprocess.Popen(cmd, env=env, stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
                                 stderr=None if r == 0 else subprocess.STDOUT, pass_fds=links)
            keep = collections.deque(maxlen=None if r == 0 else 64)
            t = threading.Thread(target=_drain, args=(p.stdout, keep), daemon=True)
            t.start()
            procs.append(p)
            outs.append(keep)
            readers.append(t)
        _close(pairs)  # a rank's peers see its socket close when it ends
        failed_at = None
        while any(p.poll() is None for p in procs):
            if failed_at is None and any(p.returncode for p in procs):
                failed_at = time.monotonic()
            if failed_at is not None and time.monotonic() - failed_at > GRACE_S:
                ended = {r for r, p in enumerate(procs) if p.poll() is None}
                break
            time.sleep(0.05)
    finally:
        _end(procs)
        _close(pairs)
        signal.signal(signal.SIGTERM, previous)
    for t in readers:
        t.join(timeout=10)
    codes = [p.returncode for p in procs]
    if all(c == 0 for c in codes):
        sys.stdout.buffer.write(b"".join(outs[0]))
        sys.stdout.flush()
        return 0
    failed = [r for r, c in enumerate(codes) if c and r not in ended]
    for r in failed:
        text = b"".join(outs[r]).decode(errors="replace")[-TAIL_BYTES:].rstrip()
        if r and text:  # rank 0's standard error has passed through already
            print(f"rtbench: the end of rank {r}'s output:\n{text}", file=sys.stderr)
    print(f"rtbench: rank exit codes {codes}; the launcher ended ranks {sorted(ended)}",
          file=sys.stderr)
    c = codes[failed[0]]
    return c if c > 0 else 128 - c


def _close(pairs):
    for pair in pairs:
        for end in pair:
            end.close()


def _end(procs):
    """Terminate the ranks still running, then kill those that outlive 5 s."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + 5
    for p in procs:
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _die_with_launcher():
    """A rank ends with its launcher, however the launcher ends."""
    if sys.platform.startswith("linux"):
        ctypes.CDLL(None, use_errno=True).prctl(PR_SET_PDEATHSIG, signal.SIGKILL)
    if os.getppid() != int(os.environ[LAUNCHER_VAR]):
        os._exit(1)


def _recv(link: socket.socket, n: int) -> bytes:
    data = b""
    while len(data) < n:
        chunk = link.recv(n - len(data))
        if not chunk:
            raise ConnectionError("a rank of the run has ended")
        data += chunk
    return data


class Group:
    """This rank's place in a run over several cards, and its sockets to its
    peers: rank 0's to ranks 1 to n - 1, in order; another rank's to rank 0."""

    def __init__(self, rank: int, world: int, links: list[socket.socket]):
        self.rank, self.world, self.links = rank, world, links

    def agree(self, stop: bool, open_slice: bool) -> tuple[bool, bool]:
        """End a step on every rank: each other rank tells rank 0 it is done
        and waits for rank 0's decisions, which rank 0 sends once it has
        heard from all: to stop after this step, and to open the traced
        slice at the next."""
        if self.rank == 0:
            for link in self.links:
                _recv(link, 1)
            flags = int(stop) | int(open_slice) << 1
            for link in self.links:
                link.sendall(bytes([flags]))
        else:
            self.links[0].sendall(b"\0")
            flags = _recv(self.links[0], 1)[0]
        return bool(flags & 1), bool(flags & 2)

    def gather(self, obj) -> list | None:
        """Every rank's ``obj`` (made of JSON's types), in rank order, on
        rank 0; None elsewhere."""
        if self.rank != 0:
            data = json.dumps(obj).encode()
            self.links[0].sendall(len(data).to_bytes(4, "big") + data)
            return None
        out = [obj]
        for link in self.links:
            out.append(json.loads(_recv(link, int.from_bytes(_recv(link, 4), "big"))))
        return out

    def close(self):
        for link in self.links:
            link.close()
        tdist.destroy_process_group()


def join(device) -> Group:
    """Join the run's group as the rank the launcher's variables name; on a
    card, take card ``LOCAL_RANK`` first."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    _die_with_launcher()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    tdist.init_process_group("nccl" if cuda else "gloo", init_method="env://", rank=rank,
                             world_size=world, timeout=timedelta(seconds=GROUP_TIMEOUT_S))
    links = [socket.socket(fileno=int(fd)) for fd in os.environ[LINKS_VAR].split(",")]
    for link in links:
        link.settimeout(GROUP_TIMEOUT_S)
    return Group(rank, world, links)


def report(rank: int, device, forbidden: list[str]) -> dict:
    """This rank's card (the current device), its peak of allocated memory
    over set-up and the window, its name, and the forbidden modules it
    holds.  On the CPU there is no card."""
    if torch.device(device).type != "cuda":
        return {"rank": rank, "card": None, "peak": 0, "name": "cpu", "forbidden": forbidden}
    return {"rank": rank, "card": torch.cuda.current_device(),
            "peak": torch.cuda.max_memory_allocated(), "name": torch.cuda.get_device_name(),
            "forbidden": forbidden}


def cards_used(reports: list[dict]) -> dict:
    """Each card on which some rank allocated memory, with the ranks' peaks
    on it summed."""
    used = collections.defaultdict(int)
    for r in reports:
        if r["card"] is not None and r["peak"] > 0:
            used[r["card"]] += r["peak"]
    return dict(sorted(used.items()))


def device_line(reports: list[dict], device) -> dict:
    """The line's ``device``: ``count`` the cards that held memory,
    ``memory_peak_bytes`` the fullest one's peak, each rank's peak, and in
    a traced run ``busy_s``, the ranks' device-busy time in the slice
    averaged over the cards."""
    used = cards_used(reports)
    line = {"platform": "gpu" if torch.device(device).type == "cuda" else "cpu",
            "kind": reports[0]["name"], "count": len(used),
            "memory_peak_bytes": max(used.values(), default=0),
            "memory_peak_bytes_per_device": [r["peak"] for r in reports]}
    if "busy_s" in reports[0]:
        line["busy_s"] = sum(r["busy_s"] for r in reports) / len(reports)
    return line


def hold(reports: list[dict], cards: int):
    """Raise `Refused` where a rank holds a forbidden module, or where fewer
    than ``cards`` cards held memory."""
    bad = [f"rank {r['rank']}: {', '.join(r['forbidden'])}" for r in reports if r["forbidden"]]
    if bad:
        raise Refused(FORBIDDEN_EXIT, "rtbench: the run loaded forbidden modules: "
                      + "; ".join(bad))
    used = cards_used(reports)
    if len(used) < cards:
        idle = [f"{r['rank']} (card {r['card']}, peak {r['peak']})" for r in reports
                if r["card"] not in used]
        shared = [f"card {c}: ranks {[r['rank'] for r in reports if r['card'] == c]}"
                  for c in used if sum(r["card"] == c for r in reports) > 1]
        raise Refused(IDLE_EXIT, f"rtbench: the run allocated memory on {len(used)} of the "
                      f"{cards} cards it was given; idle ranks: {', '.join(idle) or 'none'}"
                      + (f"; shared cards: {'; '.join(shared)}" if shared else ""))


def power_limits(cards) -> str | None:
    """``nvidia-smi``'s name and power limit of each card used, joined by
    "; " (None where it cannot say)."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = [visible.split(",")[c] for c in cards] if visible else [str(c) for c in cards]
    if not ids:
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", ",".join(ids), "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = [s.strip() for s in out.stdout.strip().splitlines() if s.strip()]
    return "; ".join(lines) if lines else None
