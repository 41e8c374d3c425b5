"""Run one cell of ``BENCHMARK.json`` and print one JSON line.

    python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One process, one cell: set-up (import, kernels built at first use into the
checkout's ``build/``, inputs made from the seed, warm-up of the cell's own
steps), then a closed loop of steps for ``--seconds`` seconds, each ending in
a synchronise, then the check of a sample of the window's outputs against
the plain reference.  With ``--trace 0`` the line carries the cell's
end-to-end metrics; with ``--trace 1`` a steady slice of the window is
profiled and the line carries its per-layer metrics, ``busy_s``,
``window_s`` and a ``breakdown``.  Without a CUDA device it prints nothing
and exits 2.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from rtbench import judge, steps, tracing  # noqa: E402
from rtbench.manifest import Manifest  # noqa: E402

PROGRAM = "unitysimpleraytracing_tpu_torch"
# Top-level modules no run may hold: JAX and the package the program ports.
FORBIDDEN = ("jax", "jaxlib", "flax", "unitysimpleraytracing_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    `FORBIDDEN`, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def run_cell(manifest: Manifest, name: str, seed: int, seconds: float, trace: bool,
             device="cuda", program=None, config=None, t0: float | None = None,
             control=None) -> dict:
    """One run of cell ``name``; returns the result line as a dict.
    ``program`` (the package module, or `rtbench.faults.Faulty` around it)
    and ``config`` (a replacement for the configuration's data) serve tests
    and `rtbench.calibrate`; ``control`` (a dtype) judges the reference in
    that precision in the program's place."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = manifest.cell(name)
    cfg = cell["config_data"] if config is None else config
    tr = cell["traffic_data"]
    rt = importlib.import_module(PROGRAM) if program is None else program
    spans = tracing.Spans(device)
    kind = steps.make(cfg, tr, seed, device, rt, spans, manifest.root)
    kind.setup()
    for i in range(tr["warmup_steps"]):
        kind.step(i)
        _sync(device)
    setup_s = time.perf_counter() - t0

    keep = judge.Reservoir(tr["check"]["outputs"], seed)
    latencies = []
    profiler = tracing.Profiler(device) if trace else None
    slice_at, slice_steps, sliced = min(1.0, 0.2 * seconds), tr["trace_steps"], None
    i, start = tr["warmup_steps"], time.perf_counter()
    in_slice = 0
    while True:
        if profiler is not None and sliced is None and in_slice == 0 \
                and time.perf_counter() - start >= slice_at:
            profiler.start()
            spans.on, in_slice = True, slice_steps
        t_step = time.perf_counter()
        if in_slice:
            with torch.profiler.record_function(tracing.STEP_RANGE):
                out = kind.step(i)
                _sync(device)
            spans.collect()
        else:
            out = kind.step(i)
            _sync(device)
        end = time.perf_counter()
        latencies.append(end - t_step)
        keep.offer(i, out)
        del out
        i += 1
        if in_slice:
            in_slice -= 1
            if in_slice == 0:
                spans.on = False
                sliced = profiler.stop(slice_steps, dict(spans.ms))
        if end - start >= seconds and not in_slice and (profiler is None or sliced):
            break
    window_s = end - start
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    kind.close()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checked = judge.check(kind, keep.kept, seed, device, tr["check"]["rays_per_output"],
                          control=control)
    checks = {kind.check_name: {"value": checked["share"],
                                "limit": tr["limits"][kind.check_name]}}

    metrics = {}
    if trace:
        ctx = SimpleNamespace(trace=sliced, unit=kind.unit, passes=kind.passes(),
                              triangles=kind.triangles)
        for m in manifest.per_layer(name):
            value = manifest.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = kind.end_to_end(window_s, latencies, setup_s)
        for m in manifest.end_to_end(name):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    if trace:
        dev.update(busy_s=sliced.busy_s, window_s=sliced.window_s)
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": len(latencies), "failed": 0, "metrics": metrics, "device": dev,
    }
    if trace:
        result["breakdown"] = sliced.breakdown()
    result["sampled"] = {k: checked[k] for k in ("sampled", "wrong", "ambiguous", "outputs",
                                                  "worst_ratio")}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest = Manifest()
    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"rtbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(manifest, args.workload, args.seed, args.seconds, bool(args.trace),
                      t0=T0)
    bad = forbidden_modules()
    if bad:
        print(f"rtbench: the run loaded forbidden modules: {', '.join(bad)}", file=sys.stderr)
        return 3
    result["device"]["power_limit"] = _power_limit()
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
