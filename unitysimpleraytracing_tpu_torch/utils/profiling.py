"""Timing, tracing and roofline accounting for the port.

Counterpart of ``unitysimpleraytracing_tpu/utils/profiling.py``, same names.
The original renderer has no observability (no timers, no profiler markers);
this module is the subsystem the framework adds.  On the card a call returns
before the device has finished, so device time is taken with CUDA events
around the work and read after ``torch.cuda.synchronize()``; on the CPU
(``device="cpu"``, the tests) the host clock is the only clock.  As
everywhere in the port, ``device=None`` means the card and raises without
one.

- `measure`, `measure_interleaved`: median seconds per call of a function, and
  variants compared round-robin so a drift hits all of them alike.
- `Timer`: one CUDA-event sample per call, optionally behind a write larger
  than the 50 MB L2 so the call finds the cache cold.
- `Profiler`, `OpStats`: named operator timings with bytes/s and op/s against
  the card's peaks.  `device_trace` wraps ``torch.profiler`` and writes a
  Chrome trace.
- `span`: the program's own ranges (``render.primary``, ``build.sah``,
  ``readback.sah_level``, ...) at each stage boundary.  While a
  ``torch.profiler`` records, each is a ``record_function`` range on the
  trace's clock, beside the kernels and copies it launched; otherwise it is
  one shared no-op context.  ``PERF.md`` lists every span and what reads it.
- `sort_bytes`, `build_bytes`, `traverse_bytes`, `roofline_ms`: what the hot
  operators must move and compute, for a roofline bound; `loaded_bytes`,
  `warp_steps` and `warp_lane_efficiency`: what a traversal kernel asks of the
  caches and how busy its warps' lanes are, from the records it popped.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from unitysimpleraytracing_tpu_torch.utils.device import resolve_device

# Published peaks of one H100 SXM (NVIDIA data sheet): device memory rate and
# float32 rate outside the tensor cores.  A roofline bound is stated against
# these whatever the card's power limit, which belongs beside the number.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# The float32 rate of code without fused multiply-adds.  The traversal
# kernels are built with -fmad=false, so every product and every sum is an
# instruction of its own, and a lane retires at most one a cycle: 132 SMs x
# 128 float32 lanes x 1.98 GHz (the H100 SXM's boost clock) = 33.45e12 a
# second, half of PEAK_F32_OPS_PER_S, which counts a multiply-add as two.
# The integer, select and load instructions around them are not counted, so
# a bound at this rate is still below what the kernels issue.
PEAK_F32_NOFMA_OPS_PER_S = 132 * 128 * 1.98e9
# Float32 operations of csrc/trace_bvh4.cu, counted from its source.
# Per popped record: 4 slab tests x (6 sub + 6 mul + 10 fmin/fmax + 3 compare).
OPS_PER_POP = 4 * 25
# Per triangle test: two crosses (18), four dots (20), 1 divide, 3 subtracts,
# 3 scalings by 1/det, u+v, 7 compares.
OPS_PER_LEAF_TEST = 53
# csrc/trace_bvh2.cu: two slab tests per popped 128-byte record; a triangle
# test also differences its vertices (e1 = b - a, e2 = c - a: 6 subtracts).
RECORD_BYTES2 = 128
OPS_PER_POP2 = 2 * 25
OPS_PER_LEAF_TEST2 = OPS_PER_LEAF_TEST + 6
# Compressed BVH4 records (trace_bvh4.compress_tables4): 208 bytes; the same
# float32 operations as OPS_PER_POP (the bf16 unpack is integer work).
RECORD_BYTES_C = 52 * 4
# Bytes the kernels load, as their code reads them.  csrc/trace_bvh4.cu: the
# four boxes and the metas of a popped record as seven 16-byte loads, and the
# 36-byte triangle of a leaf entry whose slab test passed as nine 4-byte
# loads.  csrc/trace_bvh2.cu: four 16-byte loads per popped record, and four
# more (slots 16-31, both triangles) per popped record that tests a leaf
# child (the plain walk's ``work["leaf_records"]``); the compressed entry
# point of csrc/trace_bvh4.cu: four 16-byte loads per popped record.
LOADED_BYTES_PER_POP = 7 * 16
LOADED_BYTES_PER_POP_C = 4 * 16
LOADED_BYTES_PER_LEAF_TEST = 9 * 4
LOADED_BYTES_PER_POP2 = 4 * 16
LOADED_BYTES_PER_LEAF_RECORD2 = 4 * 16


_OFF = contextlib.nullcontext()


def span(name: str):
    """A range named ``name`` around one stage of the program, recorded only
    while a ``torch.profiler`` is recording on this thread: then a
    ``torch.profiler.record_function`` range (a ``user_annotation`` event in
    the trace, nested in whatever range encloses it), else the shared no-op
    context, with no call into the profiler.  Records no CUDA event, so a
    traced slice holds the same launches as an untraced one."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    elif isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for item in x:
            t = _first_tensor(item)
            if t is not None:
                return t
    return None


def fetch(x) -> float:
    """Force a result to exist: the first element of the first tensor found in
    ``x`` (a tensor, or a tuple, list, dict or dataclass of them) as a Python
    float.  Reading a value waits for the stream that produces it."""
    t = _first_tensor(x)
    if t is None:
        raise TypeError(f"fetch: no tensor in {type(x).__name__}")
    return float(t.reshape(-1)[0])


def _is_cuda(device) -> bool:
    return resolve_device(device).type == "cuda"


def _timed_reps(fn, reps: int, cuda: bool) -> float:
    """Seconds for ``reps`` back-to-back calls: CUDA events on the card, the
    host clock (ended by a value fetch) on the CPU."""
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) * 1e-3
    t0 = time.perf_counter()
    r = None
    for _ in range(reps):
        r = fn()
    fetch(r)
    return time.perf_counter() - t0


def measure(fn, iters: int = 5, warmup: int = 2, reps: int = 8, device=None) -> float:
    """Median steady-state seconds per call of ``fn``: ``iters`` samples, each
    ``reps`` calls between two CUDA events (host clock on the CPU)."""
    cuda = _is_cuda(device)
    for _ in range(warmup):
        fetch(fn())
    samples = [_timed_reps(fn, reps, cuda) / reps for _ in range(iters)]
    return max(float(np.median(samples)), 1e-9)


def measure_interleaved(
    fns: dict, iters: int = 5, warmup: int = 1, reps: int = 4, device=None
) -> dict:
    """Compare variants under drift (clocks, power, a shared host): one
    sample of ``reps`` calls per variant per ROUND, round-robin, so a slow
    moment hits every variant equally instead of whichever variant's
    sequential block it lands on.  Returns ``{name: (median_s, min_s,
    samples)}``, seconds per call."""
    cuda = _is_cuda(device)
    for fn in fns.values():
        for _ in range(warmup):
            fetch(fn())
    samples: dict = {k: [] for k in fns}
    for _ in range(iters):
        for k, fn in fns.items():
            samples[k].append(_timed_reps(fn, reps, cuda) / reps)
    return {
        k: (max(float(np.median(v)), 1e-9), max(min(v), 1e-9), v)
        for k, v in samples.items()
    }


# Cycles the device is held busy before a `queued` sample (about 1 ms).
HOLD_CYCLES = 2_000_000


class Timer:
    """CUDA-event timing; every sample is one call, optionally after a write
    of a buffer larger than the 50 MB L2 so the call finds the cache cold.

    Without ``queued`` the start event is recorded when the host gets there,
    so a call whose launches take the host longer than the device takes to
    run them is timed at the host's pace.  ``queued=True`` holds the device
    busy (``torch.cuda._sleep``, after the flush) while the host records the
    start event and enqueues the call: the sample is then the device's time
    from the call's first launch to its last kernel's end."""

    def __init__(self):
        self.flush_buf = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")

    def flush_l2(self) -> None:
        self.flush_buf.zero_()

    def samples(self, fn, iters: int, warmup: int = 1, cold: bool = False,
                queued: bool = False):
        for _ in range(warmup):
            fn()
        out = []
        for _ in range(iters):
            if cold:
                self.flush_l2()
            if queued:
                torch.cuda._sleep(HOLD_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end))
        return out

    def median_ms(self, fn, iters: int = 5, warmup: int = 1, cold: bool = False,
                  queued: bool = False) -> float:
        return float(np.median(self.samples(fn, iters, warmup, cold, queued)))


@dataclass
class OpStats:
    name: str
    seconds: float
    bytes_accessed: int = 0
    flops: int = 0

    def gbytes_per_s(self) -> float:
        return self.bytes_accessed / self.seconds / 1e9

    def gflops_per_s(self) -> float:
        return self.flops / self.seconds / 1e9

    def roofline_fraction(
        self,
        peak_gbytes_s: float = PEAK_BYTES_PER_S / 1e9,
        peak_gflops: float = PEAK_F32_OPS_PER_S / 1e9,
    ) -> float:
        """Achieved fraction of the roofline bound (defaults: the H100 SXM's
        published device memory rate and float32 rate; pass your card's)."""
        t_mem = self.bytes_accessed / (peak_gbytes_s * 1e9)
        t_flop = self.flops / (peak_gflops * 1e9)
        bound = max(t_mem, t_flop)
        return bound / self.seconds if self.seconds > 0 else 0.0


class Profiler:
    """Collects named operator timings on the host clock, each ended by a
    device synchronise when the profiler's device is the card.

    >>> prof = Profiler()
    >>> with prof.op("build", bytes_accessed=scene_bytes):
    ...     bvh = build_bvh(scene); prof.sync(bvh)
    >>> print(prof.report())
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.stats: list[OpStats] = []

    def _wait(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def op(self, name: str, bytes_accessed: int = 0, flops: int = 0):
        self._wait()
        t0 = time.perf_counter()
        yield
        self._wait()
        self.stats.append(
            OpStats(name, time.perf_counter() - t0, bytes_accessed, flops)
        )

    def sync(self, x) -> None:
        fetch(x)

    def report(self) -> str:
        lines = [f"{'op':<24}{'ms':>10}{'GB/s':>10}{'GFLOP/s':>10}"]
        for s in self.stats:
            lines.append(
                f"{s.name:<24}{s.seconds*1e3:>10.3f}"
                f"{s.gbytes_per_s():>10.2f}{s.gflops_per_s():>10.2f}"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str, device=None):
    """Capture a ``torch.profiler`` trace of the block and write it to
    ``log_dir/trace.json`` (Chrome trace format; chrome://tracing, Perfetto).
    Yields the profiler, whose ``key_averages()`` can be read afterwards."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if _is_cuda(device):
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if ProfilerActivity.CUDA in activities:
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# Roofline byte/operation models for the hot operators ----------------------

def sort_bytes(n: int, passes: int = 4) -> int:
    """LSD radix sort traffic: each pass reads+writes keys and values (4 B
    each) plus histogram traffic (negligible)."""
    return passes * (2 * 4 + 2 * 4) * n


def build_bytes(n: int) -> int:
    """LBVH build: sort + topology reads (codes) + refit (node AABBs, ~levels
    passes over 32 B/node) — a coarse lower bound."""
    depth = max(int(np.ceil(np.log2(max(n, 2)))) + 1, 1)
    return sort_bytes(n) + n * 4 * 3 + depth * (n * 32)


def traverse_bytes(n_rays: int, records_visited: int, record_bytes: int = 256,
                   has_t_init: bool = False, has_thresh: bool = False) -> int:
    """Per-ray traversal traffic, each input read once and each output
    written once: rays in (24 B, +4 B each for a ``t_init`` seed and an
    any-hit threshold), hits out (16 B), and every DISTINCT record any ray
    popped (256 B for a BVH4 record, 128 B for a binary one)."""
    in_bytes = n_rays * (24 + 4 * bool(has_t_init) + 4 * bool(has_thresh))
    return in_bytes + records_visited * record_bytes + n_rays * 16


def roofline_ms(n_rays, has_t_init, has_thresh, records_visited, pops, leaf_tests,
                record_bytes=256, ops_per_pop=OPS_PER_POP,
                ops_per_leaf_test=OPS_PER_LEAF_TEST, peak_ops=PEAK_F32_OPS_PER_S):
    """Least time the card could take for one run's traversal: the bytes of
    `traverse_bytes` at the device memory rate against this run's float32
    operations at ``peak_ops`` (`PEAK_F32_NOFMA_OPS_PER_S` for the kernels,
    which are built without multiply-adds)."""
    min_bytes = traverse_bytes(n_rays, records_visited, record_bytes, has_t_init, has_thresh)
    t_bytes = min_bytes / PEAK_BYTES_PER_S * 1e3
    ops = pops * ops_per_pop + leaf_tests * ops_per_leaf_test
    t_ops = ops / peak_ops * 1e3
    return {
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes_ms": t_bytes,
        "operations_ms": t_ops,
        "min_bytes": min_bytes,
        "operations": ops,
    }


def loaded_bytes(pops: int, leaf_tests: int, per_pop: int = LOADED_BYTES_PER_POP,
                 per_leaf_test: int = LOADED_BYTES_PER_LEAF_TEST) -> int:
    """Record bytes a traversal kernel asks of the caches in one run: what it
    loads per popped record and per leaf test, times this run's counts (the
    ``steps`` total and the plain version's ``work["leaf_tests"]``; for the
    binary-record kernel, per popped record that tests a leaf child,
    ``work["leaf_records"]``, and `LOADED_BYTES_PER_LEAF_RECORD2`)."""
    return pops * per_pop + leaf_tests * per_leaf_test


def warp_steps(steps, warp: int = 32) -> int:
    """Steps the warps run when each run of ``warp`` consecutive rays is one
    warp and a warp runs as many steps as its longest ray: the sum over warps
    of the most records a ray of the warp popped (a ragged last warp too)."""
    s = torch.as_tensor(steps).reshape(-1).to(torch.int64)
    if s.numel() == 0:
        raise ValueError("no rays")
    s = torch.nn.functional.pad(s, (0, (-s.numel()) % warp))
    return int(s.reshape(-1, warp).max(dim=1).values.sum())


def warp_lane_efficiency(steps, warp: int = 32) -> float:
    """Share of lane-steps that do work: ``steps.sum() / (warp *
    warp_steps(steps))``.  A ragged last warp's missing lanes count as idle,
    as the threads past the end of a launch are.  1.0 where no ray took a
    step."""
    busiest = warp_steps(steps, warp)
    return 1.0 if busiest == 0 else int(torch.as_tensor(steps).sum()) / (warp * busiest)
