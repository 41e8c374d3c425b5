"""Run one cell of ``BENCHMARK.json`` and print one JSON line.

    python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One process a card.  A cell on one card runs in this process; a cell whose
``chips`` is n > 1 runs as n rank processes, one a card, that this process
starts and waits for (`rtbench.ranks`).  Each rank: set-up (import,
kernels built at first use into the checkout's ``build/``, inputs made from
the seed, warm-up of the cell's own steps), then a closed loop of steps for
``--seconds`` seconds, each ending in a synchronise (and, over several
cards, in an exchange on the host that keeps the ranks in lockstep and
carries rank 0's decision to stop), then, on rank 0 alone, the check of a
sample of the window's outputs against the plain reference.  With
``--trace 0`` the line carries the cell's end-to-end metrics; with
``--trace 1`` a steady slice of the window is profiled on every rank and
the line carries rank 0's per-layer metrics, ``window_s`` and
``breakdown``, and ``busy_s`` averaged over the ranks.  ``device`` counts
the cards on which the run allocated memory.  Exit codes: 2 without the
cards the cell asks for, 3 where a rank loaded a forbidden module, 4 where
a card held no memory; none prints a line.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from rtbench import judge, plugins, ranks, steps, tracing  # noqa: E402
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


def run_cell(manifest: Manifest, name: str, seed: int, seconds: float, trace: bool,
             device="cuda", program=None, config=None, t0: float | None = None,
             control=None, group: ranks.Group | None = None) -> dict | None:
    """One run of cell ``name``; returns the result line as a dict (None on
    a rank other than 0 of ``group``, a `rtbench.ranks.Group`, whose ranks
    all call it alike).  Raises `rtbench.ranks.Refused` where the run may
    print no result.  ``program`` (the package module, or
    `rtbench.faults.Faulty` around it) and ``config`` (a replacement for the
    configuration's data) serve tests and `rtbench.calibrate`; ``control`` (a
    dtype) judges the reference in that precision in the program's place."""
    t0 = time.perf_counter() if t0 is None else t0
    rank, world = (0, 1) if group is None else (group.rank, group.world)
    cell = manifest.cell(name)
    cfg = cell["config_data"] if config is None else config
    tr = cell["traffic_data"]
    rt = importlib.import_module(PROGRAM) if program is None else program
    spans = tracing.Spans(device)
    kind = steps.make(cfg, tr, seed, device, rt, spans, manifest.root, rank=rank, world=world)
    kind.setup()
    for i in range(tr["warmup_steps"]):
        kind.step(i)
        _sync(device)
    if group is not None:
        group.agree(False, False)
    setup_s = time.perf_counter() - t0

    keep = judge.Reservoir(tr["check"]["outputs"], seed) if rank == 0 else None
    latencies = []
    profiler = tracing.Profiler(device) if trace else None
    slice_at, slice_steps, sliced = min(1.0, 0.2 * seconds), tr["trace_steps"], None
    i, start = tr["warmup_steps"], time.perf_counter()
    in_slice, open_slice = 0, False
    while True:
        if open_slice:
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
        if in_slice:
            in_slice -= 1
            if in_slice == 0:
                spans.on = False
                sliced = profiler.stop(slice_steps, dict(spans.ms))
        stop = end - start >= seconds and not in_slice and (profiler is None or sliced is not None)
        open_slice = (profiler is not None and sliced is None and not in_slice
                      and end - start >= slice_at)
        if group is not None:
            # A step ends on every rank when the slowest card is done.
            stop, open_slice = group.agree(stop, open_slice)
            end = time.perf_counter()
        latencies.append(end - t_step)
        if keep is not None:
            keep.offer(i, out)
        del out
        i += 1
        if stop:
            break
    window_s = end - start
    cuda = torch.device(device).type == "cuda"
    mine = ranks.report(rank, device, forbidden_modules())
    if sliced is not None:
        mine["busy_s"] = sliced.busy_s
    reports = [mine] if group is None else group.gather(mine)
    if rank != 0:
        kind.close()
        return None
    # Every rank has to have used a card of its own (on the CPU, one-card
    # runs have none to use).
    ranks.hold(reports, world if group is not None or cuda else 0)

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

    dev = ranks.device_line(reports, device)
    if trace:
        dev["window_s"] = sliced.window_s
    dev["power_limit"] = ranks.power_limits(ranks.cards_used(reports)) if cuda else None
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


def main(argv=None, root: str = plugins.ROOT, device="cuda") -> int:
    """The command.  ``root`` (the checkout holding ``BENCHMARK.json``) and
    ``device`` serve the tests, which run cells of their own on the CPU."""
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest = Manifest(root)
    world = manifest.cell(args.workload)["chips"]
    if torch.device(device).type == "cuda" and (
            not torch.cuda.is_available() or torch.cuda.device_count() < world):
        print(f"rtbench: {args.workload} needs {world} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if world > 1 and not ranks.is_rank():
        return ranks.launch([sys.executable, os.path.abspath(sys.argv[0]), *argv], world, T0)
    group = ranks.join(device) if world > 1 else None
    t0 = float(os.environ[ranks.T0_VAR]) if group is not None else T0
    try:
        result = run_cell(manifest, args.workload, args.seed, args.seconds, bool(args.trace),
                          device=device, t0=t0, group=group)
    except ranks.Refused as e:
        print(e, file=sys.stderr)
        return e.code
    finally:
        if group is not None:
            group.close()
    bad = forbidden_modules()
    if bad:
        print(f"rtbench: the run loaded forbidden modules: {', '.join(bad)}", file=sys.stderr)
        return ranks.FORBIDDEN_EXIT
    if result is None:
        return 0
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
