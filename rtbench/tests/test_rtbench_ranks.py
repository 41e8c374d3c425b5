"""A cell on several cards (`rtbench.ranks`): one rank process a card, steps
in lockstep, rank 0 alone judging and printing, a device report that counts
the cards that held memory, and a command that ends when a rank fails.

The cells are a toy of the test's own, in a throwaway checkout under
``tmp_path`` (``BENCHMARK.json``, a configuration, traffic mixes, a kind and
a reader) run by the committed harness.  On the CPU the ranks form a gloo
group; a rank has no card there, so the CPU runs let rank r stand for card
r in its report.  The tests marked ``gpu`` run the same kind on the cards,
one NCCL rank a card.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

import pytest
from conftest import ROOT

from rtbench import ranks

# Each step: the value i + rank at every pixel, summed over the ranks by an
# all-reduce of the default group where ``all_reduce`` is on; rank 0's is
# judged.  Each rank logs the steps it ran and those inside the traced slice.
KIND = '''
import json
import os
import time

import torch
import torch.distributed as tdist

from rtbench.steps import Base


class Kind(Base):
    check_name = "bad_value_share"
    triangles = 0

    def setup(self):
        self.n = self.width * self.height
        self.idle = self.traffic.get("idle_last_rank") and self.rank == self.world - 1
        self.log = {"steps": [], "traced": []}

    def step(self, i):
        if self.traffic.get("fail_rank") == self.rank and i == self.traffic["fail_step"]:
            raise RuntimeError(f"rank {self.rank} fails at step {i}")
        self.log["steps"].append(i)
        if self.spans.on:
            self.log["traced"].append(i)
        time.sleep(self.traffic["sleep_s"] * (self.rank + 1))
        if self.idle:
            return None
        x = torch.full((self.n,), float(i + self.rank), device=self.device)
        if self.traffic["all_reduce"] and self.world > 1:
            tdist.all_reduce(x)
        return x

    def expected(self, i):
        ranks = range(self.world) if self.traffic["all_reduce"] else [0]
        return float(sum(i + r for r in ranks))

    def program_values(self, output, pixels):
        flat = (pixels[:, 1] * self.width + pixels[:, 0]).to(output.device)
        return output[flat].to(torch.float64)

    def reference_values(self, index, pixels, device, dtype=torch.float64):
        v = torch.full((pixels.shape[0],), self.expected(index), dtype=dtype, device=device)
        return {"v": v, "ambiguous": torch.zeros_like(v, dtype=torch.bool)}

    @staticmethod
    def ratio(got, ref):
        return (got - ref["v"]).abs()

    @classmethod
    def wrong(cls, got, ref):
        return cls.ratio(got, ref) > 0

    @staticmethod
    def as_program_output(ref_low):
        return ref_low["v"].to(torch.float64)

    def reference_inputs(self, i):
        return None

    def close(self):
        with open(os.path.join(self.root, f"rank{self.rank}.json"), "w") as f:
            json.dump(self.log, f)
'''

# The command in the throwaway checkout: the committed harness's `run.main`.
# On the CPU rank r reports card r, holding memory unless its cell leaves
# the last card idle.
CHILD = '''
import os
import sys

sys.path.insert(0, {repo!r})
from rtbench import ranks, run

real = ranks.report


def report(rank, device, forbidden):
    line = real(rank, device, forbidden)
    if device == "cpu":
        idle = "idle" in sys.argv[sys.argv.index("--workload") + 1]
        last = rank == int(os.environ.get("WORLD_SIZE", "1")) - 1
        line.update(card=rank, peak=0 if idle and last else 4096)
    return line


ranks.report = report
sys.exit(run.main(root=os.path.dirname(os.path.abspath(__file__)), device={device!r}))
'''

TRAFFIC = {"kind": "toy", "unit": "frame", "warmup_steps": 2, "trace_steps": 3,
           "check": {"outputs": 2, "rays_per_output": 64},
           "limits": {"bad_value_share": 0.0}, "sleep_s": 0.001, "all_reduce": True}
MIXES = {
    "lockstep": {},
    "fail": {"fail_rank": 1, "fail_step": 6},
    "idle": {"all_reduce": False, "idle_last_rank": True},
}
LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device", "sampled", "checks"}
DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes", "power_limit"}


def checkout(tmp_path, chips, device="cpu"):
    """A benchmark root with the toy configuration and one cell of each mix
    on ``chips`` cards (``toy.<mix>``)."""
    root = tmp_path / "checkout"
    for d in ("configs", "traffic", "kinds", "metrics"):
        (root / "rtbench" / d).mkdir(parents=True, exist_ok=True)
    (root / "rtbench/kinds/toy.py").write_text(KIND)
    (root / "rtbench/metrics/steps_in_slice.py").write_text(
        "def read(ctx):\n    return ctx.trace.steps\n")
    (root / "rtbench/configs/toy.json").write_text(json.dumps({"width": 16, "height": 16}))
    for mix, extra in MIXES.items():
        (root / f"rtbench/traffic/{mix}.json").write_text(json.dumps({**TRAFFIC, **extra}))
    (root / "child.py").write_text(CHILD.format(repo=ROOT, device=device))
    cells = [f"toy.{mix}" for mix in MIXES]
    bench = {
        "command": ["python3", "child.py"], "paths": ["rtbench"], "run_seconds": 1,
        "configs": [{"name": "toy", "source": "a test", "file": "rtbench/configs/toy.json",
                     "reduced": [], "why": "a test"}],
        "workloads": [{"name": c, "config": "toy", "traffic": c.split(".")[1],
                       "chips": chips, "why": "a test"} for c in cells],
        "end_to_end": [{"name": n, "unit": u, "better": "lower", "bound": 0.25,
                        "source": "host_clock"}
                       for n, u in (("frame_ms", "ms"), ("frame_ms_p95", "ms"), ("setup_s", "s"))],
        "per_layer": [{"name": "steps_in_slice", "unit": "steps", "better": "higher",
                       "source": "device_trace", "layer": "device", "moves": "frame_ms"}],
    }
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def command(root, cell, trace=0, seconds=1.0, timeout=90, **popen):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "RANK", "WORLD_SIZE", ranks.T0_VAR)}
    env["OMP_NUM_THREADS"] = "1"
    args = [sys.executable, "child.py", "--workload", cell, "--seed", str(2**31 + 11),
            "--seconds", str(seconds), "--trace", str(trace)]
    if popen:
        return subprocess.Popen(args, cwd=root, env=env, **popen)
    return subprocess.run(args, cwd=root, env=env, capture_output=True, text=True,
                          timeout=timeout)


def rank_logs(root, world):
    return [json.loads((root / f"rank{r}.json").read_text()) for r in range(world)]


@pytest.mark.parametrize("world,trace", [(2, 0), (4, 1)])
def test_ranks_run_the_same_steps_and_rank_0_alone_prints(tmp_path, world, trace):
    root = checkout(tmp_path, world)
    p = command(root, "toy.lockstep", trace=trace)
    assert p.returncode == 0, p.stderr[-4000:]
    lines = p.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["correct"] and line["sampled"]["wrong"] == 0, line["checks"]
    assert line["device"]["count"] == world
    assert line["device"]["memory_peak_bytes_per_device"] == [4096] * world
    assert p.stderr.strip().splitlines()[-1].startswith("check bad_value_share")
    logs = rank_logs(root, world)
    assert all(log == logs[0] for log in logs)
    # Warm-up steps, then the window's: the line counts the window's.
    assert len(logs[0]["steps"]) == TRAFFIC["warmup_steps"] + line["attempted"]
    if trace:
        assert logs[0]["traced"] and len(logs[0]["traced"]) == TRAFFIC["trace_steps"]
        assert line["metrics"]["steps_in_slice"]["value"] == TRAFFIC["trace_steps"]
        assert "busy_s" in line["device"] and "breakdown" in line


def test_a_failing_rank_ends_the_command(tmp_path):
    root = checkout(tmp_path, 2)
    t = time.monotonic()
    p = command(root, "toy.fail", seconds=30)
    took = time.monotonic() - t
    assert p.returncode == 1 and p.stdout == "", p.stderr[-4000:]
    assert "rank 1 fails at step 6" in p.stderr
    assert took < 30 < ranks.GROUP_TIMEOUT_S


def test_an_idle_card_fails_the_run(tmp_path):
    root = checkout(tmp_path, 2)
    p = command(root, "toy.idle")
    assert p.returncode == ranks.IDLE_EXIT and p.stdout == "", p.stderr[-4000:]
    assert "on 1 of the 2 cards" in p.stderr and "idle ranks: 1 (card 1, peak 0)" in p.stderr


def _children(pid):
    out = subprocess.run(["ps", "-o", "pid=", "--ppid", str(pid)], capture_output=True,
                         text=True).stdout
    return [int(x) for x in out.split()]


def _alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


@pytest.mark.parametrize("sig", [signal.SIGTERM, signal.SIGKILL])
def test_the_ranks_end_with_the_launcher(tmp_path, sig):
    root = checkout(tmp_path, 2)
    p = command(root, "toy.lockstep", seconds=60, stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 60
        while len(_children(p.pid)) < 2 and time.monotonic() < deadline:
            time.sleep(0.1)
        ranks_ = _children(p.pid)
        assert len(ranks_) == 2
        time.sleep(2)
        p.send_signal(sig)
        out, _ = p.communicate(timeout=30)
        deadline = time.monotonic() + 10
        while any(map(_alive, ranks_)) and time.monotonic() < deadline:
            time.sleep(0.1)
    finally:
        p.kill()
        p.wait()
    assert p.returncode != 0 and out == b""
    assert not any(map(_alive, ranks_))


def report(rank, card, peak, name="NVIDIA H100 80GB HBM3", forbidden=()):
    return {"rank": rank, "card": card, "peak": peak, "name": name,
            "forbidden": list(forbidden)}


def test_the_report_counts_cards_that_held_memory():
    four = [report(r, r, 1000 * (r + 1)) for r in range(4)]
    line = ranks.device_line(four, "cuda")
    assert line == {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4,
                    "memory_peak_bytes": 4000,
                    "memory_peak_bytes_per_device": [1000, 2000, 3000, 4000]}
    ranks.hold(four, 4)

    # Every rank on card 0: one card used, its peak the ranks' together.
    shared = [report(r, 0, 1000) for r in range(4)]
    assert ranks.device_line(shared, "cuda")["count"] == 1
    assert ranks.device_line(shared, "cuda")["memory_peak_bytes"] == 4000
    with pytest.raises(ranks.Refused) as e:
        ranks.hold(shared, 4)
    assert e.value.code == ranks.IDLE_EXIT and "card 0: ranks [0, 1, 2, 3]" in str(e.value)

    idle = four[:3] + [report(3, 3, 0)]
    assert ranks.device_line(idle, "cuda")["count"] == 3
    with pytest.raises(ranks.Refused) as e:
        ranks.hold(idle, 4)
    assert e.value.code == ranks.IDLE_EXIT and "idle ranks: 3 (card 3, peak 0)" in str(e.value)

    traced = [{**r, "busy_s": b} for r, b in zip(four, (0.1, 0.2, 0.3, 0.6))]
    assert ranks.device_line(traced, "cuda")["busy_s"] == pytest.approx(0.3)

    one = [report(0, 0, 737876480)]
    assert ranks.device_line(one, "cuda")["count"] == 1
    ranks.hold(one, 1)
    with pytest.raises(ranks.Refused) as e:
        ranks.hold([report(0, 0, 0)], 1)
    assert e.value.code == ranks.IDLE_EXIT
    # On the CPU a one-card run has no card to use.
    cpu = [ranks.report(0, "cpu", [])]
    assert ranks.device_line(cpu, "cpu")["count"] == 0
    ranks.hold(cpu, 0)


def test_a_forbidden_module_on_any_rank_refuses_the_run():
    reps = [report(0, 0, 1), report(1, 1, 1, forbidden=["jax"])]
    with pytest.raises(ranks.Refused) as e:
        ranks.hold(reps, 2)
    assert e.value.code == ranks.FORBIDDEN_EXIT and "rank 1: jax" in str(e.value)


def test_a_one_card_line_keeps_its_keys(tmp_path, capsys):
    from rtbench import run

    root = checkout(tmp_path, 1)
    code = run.main(["--workload", "toy.lockstep", "--seed", "7", "--seconds", "0.3",
                     "--trace", "0"], root=str(root), device="cpu")
    out = capsys.readouterr()
    assert code == 0, out.err[-4000:]
    line = json.loads(out.out.strip().splitlines()[-1])
    assert set(line) == LINE_KEYS and list(line)[-1] == "checks"
    assert set(line["device"]) == DEVICE_KEYS | {"memory_peak_bytes_per_device"}
    assert line["device"]["memory_peak_bytes_per_device"] == [0]
    assert line["correct"] and set(line["metrics"]) == {"frame_ms", "frame_ms_p95", "setup_s"}
    assert rank_logs(root, 1)[0]["steps"]


@pytest.fixture
def cards():
    import torch

    n = min(4, torch.cuda.device_count()) if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip("needs two CUDA devices or more")
    return n


@pytest.mark.gpu
def test_every_card_of_the_cell_holds_memory(cards, tmp_path):
    root = checkout(tmp_path, cards, device="cuda")
    p = command(root, "toy.lockstep", seconds=2, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert line["device"]["count"] == cards
    peaks = line["device"]["memory_peak_bytes_per_device"]
    assert len(peaks) == cards and min(peaks) > 0
    assert len(line["device"]["power_limit"].split("; ")) == cards
    logs = rank_logs(root, cards)
    assert all(log == logs[0] for log in logs)


@pytest.mark.gpu
def test_a_card_left_idle_fails_the_run(cards, tmp_path):
    root = checkout(tmp_path, cards, device="cuda")
    p = command(root, "toy.idle", seconds=2, timeout=600)
    assert p.returncode == ranks.IDLE_EXIT and p.stdout == "", p.stderr[-4000:]
    assert f"idle ranks: {cards - 1} (card {cards - 1}, peak 0)" in p.stderr
