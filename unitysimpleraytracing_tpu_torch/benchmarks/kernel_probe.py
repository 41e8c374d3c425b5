"""Primitive cost probes: what one dependent step of a traversal loop costs.

Counterpart of the JAX package's ``benchmarks/kernel_probe.py``.  Times tiny
serial loops that isolate one primitive per iteration, so traversal-kernel
design decisions rest on measured per-operation costs instead of guesses:

    python -m unitysimpleraytracing_tpu_torch.benchmarks.kernel_probe \\
        [--iters 20000] [--seed 0] [--device cpu]

Each P1 probe prints ``{"probe", "ns_per_iter", ...}`` (``empty`` is the loop
alone: subtract it yourself, nothing is subtracted here), each P2 probe
``{"probe", "ns_per_row", "bytes_per_row", ...}``, each with the probe's
output value, the device and how the time was taken.  A probe that fails
raises; nothing is swallowed.

Kernel note.  `probe_kernel` (P1) and `dma_probe_kernel` (P2) launch
``csrc/kernel_probe.cu``, the hand-written CUDA kernels that replace the two
Pallas kernels of the JAX script (the kernels of its ``run_probe`` and
``run_dma_probe``).  They are serial chains by definition, bound by the
latency of the dependent operation and not by bytes or operations: P1 is one
block — 1024 threads (one lane of the TPU's (8, 128) vector carry each, the
scalar carry uniform) for the variants that touch the vector carry, one warp
for the scalar ones, so that a scalar chain is not timed through 32 warps
sharing four warp schedulers — and P2 is one warp issuing ``cp.async`` row copies
into a ``depth``-slot shared-memory buffer.  The variants under the JAX script's
names compute what its kernels compute; the ``dep_*`` variants exist only
here (a fetch whose row depends on the data just fetched, through L1, past
L1, from shared memory, and from a per-thread local-memory stack) and read
the cost of one pop of the traversal kernels; their chase ``r -> (37 r + 11 +
tab[r]) & 4095`` is a random mapping whose orbit soon falls into a cycle of a
few dozen rows, so the ``l1`` forms time L1 hits and the ``l2`` forms
(``ld.global.cg``) L2 hits, not a mix.  Beside each wrapper stands its
plain PyTorch version (`run_probe_plain`, `run_dma_probe_plain`): a host loop
of tensor operations that repeats the kernel's arithmetic step by step.  The
tables hold small integers as float32 (made from ``--seed``), so every sum is
exact and kernel and plain version agree bit for bit whatever the reduction
order.  On a CUDA tensor a wrapper launches its kernel or raises; on a CPU
tensor it runs the plain version and counts no launch.

Time per iteration is a slope: launches of N and 4N iterations between CUDA
events, ``(t(4N) - t(N)) / 3N``, so the launch cost does not enter.  The P2
table of the JAX script (16 MB) fits this card's 50 MB L2, so each P2 variant
is reported twice: from the warm 16 MB table (L2 resident) and, as
``<name>_devmem``, from a 256 MB-per-512-byte-row table with the L2 flushed
before every launch (device memory).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
import time

import numpy as np
import torch

from unitysimpleraytracing_tpu_torch.utils import kernel_build, profiling
from unitysimpleraytracing_tpu_torch.utils.device import resolve_device

KERNEL_NAME = "kernel_probe"
TAB_SHAPE = (4096, 16)
SMEM_ROWS = 2048
STACK_DEPTH = 64
ROW_FLOATS = 128                 # one 512-byte row of the P2 table
L2_ROWS = 1 << 15                # the JAX script's table: 16 MB at 512 B a row
DEVMEM_ROWS = 1 << 19            # 256 MB at 512 B a row: five times the L2
TABLE_VALUES = 8                 # tables hold integers in [0, 8)
LCG_A, LCG_C = 1103515245, 12345
SLOPE_REPS = 5                   # timed (N, 4N) pairs per probe; the median is kept

# name -> (variant code of csrc/kernel_probe.cu, fetch count K, block size)
P1_VARIANTS = {
    "empty": (0, 0, 32),
    "fetch_x1": (1, 1, 32), "fetch_x4": (1, 4, 32), "fetch_x8": (1, 8, 32),
    "fetch_x16": (1, 16, 32), "fetch_x32": (1, 32, 32),
    "reduce_sum_8x128": (2, 0, 1024),
    "reduce_sum_x2": (3, 0, 1024),
    "vector_40ops": (4, 0, 1024),
    "fetch_packed_switch8_x2": (5, 0, 32),
    # Only here.  The loop alone at the block size of the vector variants:
    "empty_block1024": (0, 0, 1024),
    # ... and fetches whose row depends on the value just fetched.
    "dep_fetch_l1_x1": (6, 0, 32),
    "dep_fetch_l2_x1": (7, 0, 32),
    "dep_fetch_l1_row64": (8, 0, 32),
    "dep_fetch_l2_row64": (9, 0, 32),
    "dep_fetch_smem_x1": (10, 0, 32),
    "dep_local_stack_x1": (11, 0, 32),
}
# The probes of the JAX script, in its order; the rest exist only here.
P1_JAX_NAMES = tuple(list(P1_VARIANTS)[:10])
P1_NEW_NAMES = tuple(list(P1_VARIANTS)[10:])
# name -> (depth, rows_per_rec), the JAX script's five.
P2_VARIANTS = {
    "dma_row512_serial": (1, 1),
    "dma_row512_batch2": (2, 1),
    "dma_row512_batch4": (4, 1),
    "dma_row512_batch8": (8, 1),
    "dma_row2048_batch8": (8, 4),
}


def make_table(seed: int = 0, device=None) -> torch.Tensor:
    """The (4096, 16) float32 P1 table: integers in [0, 8) from ``seed``."""
    rng = np.random.default_rng(seed)
    tab = rng.integers(0, TABLE_VALUES, size=TAB_SHAPE).astype(np.float32)
    return torch.from_numpy(tab).to(resolve_device(device))


def make_dma_table(seed: int = 0, rows: int = L2_ROWS, rows_per_rec: int = 1,
                   device=None, chain_neutral: bool = True) -> torch.Tensor:
    """The (rows * rows_per_rec, 128) float32 P2 table: integers in [0, 8).
    Made on the device from a seeded generator (a 1 GB table is not made on
    the host); the CPU and the card give different values from one seed.

    ``chain_neutral`` zeroes column 1, the value a round folds into the next
    round's base.  The kernel still has to wait for it — the dependence is
    real — but the chain stays the LCG, whose period is the row count.  With
    data there, ``x -> lcg(x ^ data[x])`` is a random mapping: its orbit falls
    into a cycle of about sqrt(rows) rows after about as many rounds, and a
    table five times the L2 then answers from the L2.  The timed tables are
    neutral; the comparison with the plain version also runs on a table that
    is not, so that the fold itself is checked."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    table = torch.randint(
        0, TABLE_VALUES, (rows * rows_per_rec, ROW_FLOATS), generator=gen, device=device,
        dtype=torch.float32,
    )
    if chain_neutral:
        table[:, 1] = 0.0
    return table


def dma_rounds(iters: int, depth: int) -> int:
    """Rounds of one P2 run: the JAX script's ``max(iters // 10, 1000) // depth``."""
    return max(iters // 10, 1000) // depth


# ---- P1 ----------------------------------------------------------------------


def _check_p1(name: str, tab: torch.Tensor, n_iters: int) -> None:
    if name not in P1_VARIANTS:
        raise KeyError(f"no probe {name!r}; one of {sorted(P1_VARIANTS)}")
    if tab.dtype != torch.float32 or tuple(tab.shape) != TAB_SHAPE or not tab.is_contiguous():
        raise ValueError(f"the table must be contiguous float32 {TAB_SHAPE}, got "
                         f"{tab.dtype} {tuple(tab.shape)}")
    if n_iters < 0:
        raise ValueError(f"n_iters must be >= 0, got {n_iters}")


@torch.no_grad()
def run_probe_plain(name: str, tab: torch.Tensor, n_iters: int) -> torch.Tensor:
    """Plain version of `probe_kernel`: the same loop as a host loop of tensor
    operations on ``tab``'s device, one float32 out (shape (1,)).  Every sum
    and product is a separate float32 operation in the kernel's order."""
    _check_p1(name, tab, n_iters)
    dev = tab.device
    code, k, _ = P1_VARIANTS[name]
    s = torch.zeros((), dtype=torch.float32, device=dev)
    v = torch.zeros((8, 128), dtype=torch.float32, device=dev)
    flat = tab.reshape(-1)
    chase = torch.zeros((), dtype=torch.int64, device=dev)
    stack = torch.zeros((STACK_DEPTH,), dtype=torch.float32, device=dev)
    for i in range(n_iters):
        if code == 0:
            s = s + 1.0
        elif code == 1:
            r = (i * 37 + 11) & (TAB_SHAPE[0] - 1)
            for c in range(k):
                s = s + tab[r, c % TAB_SHAPE[1]]
        elif code == 2:
            s = s + torch.sum(v + 1.0)
        elif code == 3:
            a = torch.sum(v + 1.0)
            b = torch.sum(v + 2.0)
            s = s + a + b
        elif code == 4:
            x = v
            for _ in range(10):
                x = x * 1.0001 + 0.5
                x = torch.clamp(x, max=3.0)
                x = torch.clamp(x, min=-3.0)
                x = x - 0.1
            v = x
        elif code == 5:
            r = (i * 37 + 11) & (TAB_SHAPE[0] * 8 - 1)
            row, j = r >> 3, r & 7
            s = s + tab[row, 2 * j] + tab[row, 2 * j + 1]
        elif code in (6, 7, 10):
            val = flat[chase * TAB_SHAPE[1]]
            s = s + val
            mask = (SMEM_ROWS if code == 10 else TAB_SHAPE[0]) - 1
            chase = (chase * 37 + 11 + val.to(torch.int64)) & mask
        elif code in (8, 9):
            row = flat[chase * TAB_SHAPE[1] + torch.arange(16, device=dev)]
            val = row[0] + row[5] + row[10] + row[15]
            s = s + val
            chase = (chase * 37 + 11 + val.to(torch.int64)) & (TAB_SHAPE[0] - 1)
        else:
            w = (i * 37 + 11) & (STACK_DEPTH - 1)
            stack[w] = float(i & 7)
            rd = (s.to(torch.int64) + (w * 5 + 3)) & (STACK_DEPTH - 1)
            s = s + stack[rd]
    return (s + v[0, 0]).reshape(1)


def _load_kernel():
    """The kernels' C entry points, built by nvcc on first use."""
    lib = kernel_build.load_kernel_library(KERNEL_NAME)
    p1, p2 = lib.kernel_probe_p1_launch, lib.kernel_probe_p2_launch
    if p1.argtypes is None:
        p1.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        p1.restype = ctypes.c_int
        p2.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_uint, ctypes.c_void_p]
        p2.restype = ctypes.c_int
    return p1, p2


@torch.no_grad()
def probe_kernel(name: str, tab: torch.Tensor, n_iters: int) -> torch.Tensor:
    """P1: ``n_iters`` iterations of probe ``name`` over the (4096, 16)
    float32 table; one float32 out (shape (1,)).

    On a CUDA tensor this launches the hand-written kernel (one block of 1024
    or 32 threads) on the current stream without synchronising, or raises; it never
    gives way to the plain version.  On a CPU tensor it runs
    `run_probe_plain`.  ``probe_kernel.launches`` counts kernel launches."""
    _check_p1(name, tab, n_iters)
    if tab.device.type == "cpu":
        return run_probe_plain(name, tab, n_iters)
    if tab.device.type != "cuda":
        raise ValueError(f"unsupported device {tab.device}")
    launch, _ = _load_kernel()
    code, k, threads = P1_VARIANTS[name]
    out = torch.empty((1,), dtype=torch.float32, device=tab.device)
    with torch.cuda.device(tab.device):
        stream = torch.cuda.current_stream(tab.device).cuda_stream
        err = launch(tab.data_ptr(), out.data_ptr(), code, k, n_iters, threads, stream)
    if err != 0:
        raise RuntimeError(f"kernel_probe P1 ({name}) launch failed: CUDA error {err}")
    probe_kernel.launches += 1
    return out


probe_kernel.launches = 0


# ---- P2 ----------------------------------------------------------------------


def _check_p2(table: torch.Tensor, depth: int, rows_per_rec: int, rounds: int) -> int:
    """Raise on what the kernel does not take; returns the row count."""
    if depth not in (1, 2, 4, 8) or rows_per_rec not in (1, 4):
        raise ValueError(f"depth in (1, 2, 4, 8) and rows_per_rec in (1, 4), got "
                         f"{depth}, {rows_per_rec}")
    if (table.dtype != torch.float32 or table.ndim != 2 or table.shape[1] != ROW_FLOATS
            or not table.is_contiguous() or table.shape[0] % rows_per_rec):
        raise ValueError(f"the table must be contiguous float32 (rows * {rows_per_rec}, "
                         f"{ROW_FLOATS}), got {table.dtype} {tuple(table.shape)}")
    rows = table.shape[0] // rows_per_rec
    if rows < 2 or rows & (rows - 1) or rows > 1 << 31:
        raise ValueError(f"the row count must be a power of two in [2, 2^31], got {rows}")
    if rounds < 0:
        raise ValueError(f"rounds must be >= 0, got {rounds}")
    return rows


@torch.no_grad()
def run_dma_probe_plain(table: torch.Tensor, depth: int, rows_per_rec: int,
                        rounds: int) -> torch.Tensor:
    """Plain version of `dma_probe_kernel`: the same LCG chain, the same
    ``depth`` row copies per round into a scratch tensor, the same
    accumulation and the same data dependence into the next round, as a host
    loop; one float32 out (shape (1,))."""
    rows = _check_p2(table, depth, rows_per_rec, rounds)
    dev = table.device
    scratch = torch.zeros((depth * rows_per_rec, ROW_FLOATS), dtype=torch.float32, device=dev)
    acc = torch.zeros((), dtype=torch.float32, device=dev)
    base = 1
    for _ in range(rounds):
        x = base
        idxs = []
        for _ in range(depth):
            x = (x * LCG_A + LCG_C) & (rows - 1)
            idxs.append(x)
        for j, idx in enumerate(idxs):
            scratch[j * rows_per_rec:(j + 1) * rows_per_rec] = table[
                idx * rows_per_rec:(idx + 1) * rows_per_rec]
        for j in range(depth):
            acc = acc + scratch[j * rows_per_rec, 0]
        base = idxs[-1] ^ int(scratch[0, 1])  # one device→host read a round
    return acc.reshape(1)


@torch.no_grad()
def dma_probe_kernel(table: torch.Tensor, depth: int, rows_per_rec: int,
                     rounds: int) -> torch.Tensor:
    """P2: ``rounds`` rounds of ``depth`` asynchronous copies of one
    ``512 * rows_per_rec``-byte row each, rows drawn from an LCG chain seeded
    by the data of the round before; one float32 out (shape (1,)).

    On a CUDA tensor this launches the hand-written kernel (one warp,
    ``cp.async`` into shared memory) on the current stream without
    synchronising, or raises; it never gives way to the plain version.  On a
    CPU tensor it runs `run_dma_probe_plain`.  ``dma_probe_kernel.launches``
    counts kernel launches."""
    rows = _check_p2(table, depth, rows_per_rec, rounds)
    if table.device.type == "cpu":
        return run_dma_probe_plain(table, depth, rows_per_rec, rounds)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    if table.data_ptr() % 16:
        raise ValueError("the table must be 16-byte aligned")
    _, launch = _load_kernel()
    out = torch.empty((1,), dtype=torch.float32, device=table.device)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = launch(table.data_ptr(), out.data_ptr(), depth, rows_per_rec, rounds,
                     rows - 1, stream)
    if err != 0:
        raise RuntimeError(f"kernel_probe P2 (depth {depth}) launch failed: CUDA error {err}")
    dma_probe_kernel.launches += 1
    return out


dma_probe_kernel.launches = 0


# ---- the measurement ---------------------------------------------------------


def _slope_seconds(run, n: int, device: torch.device, before=None):
    """(seconds per unit of ``n``, value at ``n``, how it was timed): on the
    card the median over `SLOPE_REPS` of ``(t(4n) - t(n)) / 3n`` with CUDA events
    around each launch (``before`` runs ahead of every timed launch, outside
    the events); on the CPU the host clock over one run of ``n``."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        value = float(run(n)[0])
        return (time.perf_counter() - t0) / max(n, 1), value, "host clock, one run (CPU)"

    def timed(count):
        if before is not None:
            before()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run(count)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) * 1e-3, out

    timed(4 * n)  # warm-up: builds the kernel, loads the code, touches the rows
    slopes = []
    for _ in range(SLOPE_REPS):
        t1, out = timed(n)
        t4, _ = timed(4 * n)
        slopes.append((t4 - t1) / (3 * n))
    return (max(float(np.median(slopes)), 1e-12), float(out[0]),
            f"CUDA events, slope (t(4N) - t(N)) / 3N, median of {SLOPE_REPS}")


def _device_label(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def run_probe(name: str, iters: int = 20000, seed: int = 0, device=None,
              tab: torch.Tensor | None = None) -> dict:
    """Time one P1 probe and print its JSON line; returns the line's dict."""
    device = resolve_device(device)
    if tab is None:
        tab = make_table(seed, device)
    per_iter, value, how = _slope_seconds(
        lambda n: probe_kernel(name, tab, n), iters, device)
    line = {"probe": name, "ns_per_iter": round(per_iter * 1e9, 3), "value": value,
            "iters": iters, "device": _device_label(device), "timing": how}
    print(json.dumps(line), flush=True)
    return line


def run_dma_probe(name: str, depth: int, rows_per_rec: int = 1, iters: int = 20000,
                  seed: int = 0, device=None, rows: int = L2_ROWS, flush=None) -> dict:
    """Time one P2 probe and print its JSON line; returns the line's dict.
    ``flush`` (a callable, e.g. `profiling.Timer.flush_l2`) runs before every
    timed launch: with it and a table larger than the L2 the rows come from
    device memory."""
    device = resolve_device(device)
    table = make_dma_table(seed, rows, rows_per_rec, device)
    rounds = dma_rounds(iters, depth)
    per_round, value, how = _slope_seconds(
        lambda n: dma_probe_kernel(table, depth, rows_per_rec, n), rounds, device,
        before=flush)
    line = {"probe": name, "ns_per_row": round(per_round / depth * 1e9, 3),
            "bytes_per_row": 512 * rows_per_rec, "value": value,
            "rows_fetched": rounds * depth, "depth": depth,
            "table_mb": table.numel() * 4 / 2**20,
            "memory": ("device memory (L2 flushed before each launch)" if flush is not None
                       else "L2 resident (warm)") if device.type == "cuda" else "host",
            "device": _device_label(device), "timing": how}
    print(json.dumps(line), flush=True)
    return line


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--iters", type=int, default=20000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run; 'cuda' (default) fails when no card is present")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    print(f"[probe] device={_device_label(device)} iters={args.iters}", file=sys.stderr,
          flush=True)

    lines = []
    tab = make_table(args.seed, device)
    for name in P1_VARIANTS:
        lines.append(run_probe(name, args.iters, args.seed, device, tab=tab))
    flush = profiling.Timer().flush_l2 if on_card else None
    for name, (depth, rpr) in P2_VARIANTS.items():
        lines.append(run_dma_probe(name, depth, rpr, args.iters, args.seed, device))
        if on_card:
            # The same chain over a table five times the L2, cache flushed.
            lines.append(run_dma_probe(name + "_devmem", depth, rpr, args.iters, args.seed,
                                       device, rows=DEVMEM_ROWS, flush=flush))
    return lines


if __name__ == "__main__":
    main()
