"""The traced run: spans the benchmark records around its calls into the
program, and a `torch.profiler` slice over steady steps of the window.

Spans are off outside the slice (a no-op context), so untraced runs pay
nothing.  In the slice each span is a profiler range and a pair of CUDA
events read after the step's synchronise.  The slice's trace is written to
a temporary file under ``TMPDIR``, read back and deleted; `TraceSlice`
holds what the per-layer readers (``rtbench/metrics/*.py``) take from it.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

from rtbench import stats

STEP_RANGE = "rtbench.step"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "cuda_runtime", "cuda_driver")
TOP = 10
NAME_CHARS = 100


class Spans:
    """``spans(name)`` around a call into the program: a profiler range and
    its time (CUDA events on the card, the host clock elsewhere) while on."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.on = False
        self.pending = []
        self.ms = defaultdict(list)

    def __call__(self, name: str):
        return self._span(name) if self.on else contextlib.nullcontext()

    @contextlib.contextmanager
    def _span(self, name: str):
        with torch.profiler.record_function(name):
            if self.cuda:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
            else:
                t0 = time.perf_counter()
            try:
                yield
            finally:
                if self.cuda:
                    end.record()
                    self.pending.append((name, start, end))
                else:
                    self.ms[name].append((time.perf_counter() - t0) * 1e3)

    def collect(self):
        """After the step's synchronise: the pending spans' times."""
        for name, start, end in self.pending:
            self.ms[name].append(start.elapsed_time(end))
        self.pending.clear()


class TraceSlice:
    """What a profiled slice of ``steps`` steps showed, times in µs on the
    trace's clock: device intervals and kernels, host events, the slice's
    bounds, and the spans' ms."""

    def __init__(self, events: list, steps: int, spans: dict):
        self.steps, self.spans = steps, spans
        ranges = [(e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("name") == STEP_RANGE and e.get("cat") == "user_annotation"]
        if not ranges:
            raise RuntimeError("the trace holds no step range")
        self.lo, self.hi = min(r[0] for r in ranges), max(r[1] for r in ranges)
        inside = [e for e in events if e.get("ph") == "X" and "dur" in e
                  and e["ts"] < self.hi and e["ts"] + e["dur"] > self.lo]
        self.device = [e for e in inside if e.get("cat") in DEVICE_CATEGORIES]
        self.kernels = [e for e in self.device if e["cat"] == "kernel"]
        self.host = [e for e in inside if e.get("cat") in HOST_CATEGORIES]
        self.ranges = [e for e in inside if e.get("cat") == "user_annotation"
                       and e.get("name") != STEP_RANGE]

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) * 1e-6

    def intervals(self, events=None):
        return [(e["ts"], e["ts"] + e["dur"]) for e in (self.device if events is None else events)]

    @property
    def busy_s(self) -> float:
        return stats.union_length(self.intervals(), self.lo, self.hi) * 1e-6

    def breakdown(self) -> dict:
        """The device operations that took most time, and the longest idle
        gaps, each named by the host activity at its middle."""
        by_name = defaultdict(float)
        for e in self.device:
            by_name[e["name"][:NAME_CHARS]] += e["dur"] * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        holes = sorted(stats.gaps(self.intervals(), self.lo, self.hi),
                       key=lambda g: g[0] - g[1])[:TOP]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[self._host_at((s + e) / 2), (e - s) * 1e-6] for s, e in holes]}

    def _host_at(self, t: float) -> str:
        def innermost(events):
            over = [e for e in events if e["ts"] <= t <= e["ts"] + e["dur"]]
            return min(over, key=lambda e: e["dur"])["name"] if over else None

        names = [n for n in (innermost(self.ranges), innermost(self.host)) if n]
        return " / ".join(names) if names else "between steps"


class Profiler:
    """`torch.profiler` over the slice; `stop` returns a `TraceSlice`."""

    def __init__(self, device):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)

    def start(self):
        self.prof.__enter__()

    def stop(self, steps: int, spans: dict) -> TraceSlice:
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(prefix="rtbench_trace_", suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        return TraceSlice(events, steps, spans)
