"""Readings for the limits of ``correct``, on the card, one process per call:

    python3 rtbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 7,8,9] [--faults stale,half,altered] [--seconds 2] \\
        [--out calibrate.jsonl]

For each seed a short window of the program and its check (the lower
reading: sound runs); for each control seed the same window judged with the
reference in bfloat16 in the program's place (the control); for each fault
a window with that fault planted (`rtbench.faults`).  One JSON line each.
A cell on n > 1 cards runs as n ranks, one a card, that go through the same
jobs together (`rtbench.ranks`); rank 0 prints.  The benchmark's own runs
never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from rtbench import faults, ranks, run  # noqa: E402
from rtbench.manifest import Manifest  # noqa: E402


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    manifest = Manifest()
    world = manifest.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        print(f"calibrate: {args.workload} needs {world} CUDA device(s)", file=sys.stderr)
        return 2
    if world > 1 and not ranks.is_rank():
        return ranks.launch([sys.executable, os.path.abspath(sys.argv[0]), *argv], world,
                            run.T0)
    group = ranks.join("cuda") if world > 1 else None
    import unitysimpleraytracing_tpu_torch as program

    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    jobs = ([("program", s, None) for s in ints(args.seeds)]
            + [("control", s, None) for s in ints(args.control_seeds)]
            + [(f"fault:{f}", s, f) for f in args.faults.split(",") if f
               for s in ints(args.control_seeds)])
    out = open(args.out, "a") if args.out and (group is None or group.rank == 0) else None
    try:
        for what, seed, fault in jobs:
            prog = faults.Faulty(program, fault) if fault else program
            r = run.run_cell(manifest, args.workload, seed, args.seconds, False,
                             program=prog, control=torch.bfloat16 if what == "control" else None,
                             group=group)
            if r is None:
                continue
            line = {"workload": args.workload, "what": what, "seed": seed,
                    "correct": r["correct"], "checks": r["checks"], "sampled": r["sampled"],
                    "metrics": {k: v["value"] for k, v in r["metrics"].items()}}
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
                out.flush()
    finally:
        if out:
            out.close()
        if group is not None:
            group.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
