"""K1 (BVH4 traversal), K1c (its compressed-record variant), K5 (exclusive
scan) and the frame with shadows, timed through the package's public entry
points, to compare two checkouts on one card in turns.

    python unitysimpleraytracing_tpu_torch/benchmarks/kernel_ab.py \\
        [--root DIR] [--iters 7] [--out FILE]

``--root DIR`` imports ``unitysimpleraytracing_tpu_torch`` from DIR (for
example a parent commit unpacked with ``git archive`` into a git-ignored
directory) instead of from the checkout this file lies in, so DIR's kernels
are built from DIR's sources by DIR's own code.  Run it once per checkout, in
turns (parent, change, change, parent), in one call to the card.  Run it by
its path, not with ``-m``, so the package is imported from ``--root``.

Timing: this file's own checkout's `utils/profiling.Timer`, loaded from its
path so that an older package can be measured: CUDA events, the device held
while the host enqueues, median of ``--iters``; kernels with a cold L2 (and
K1's primary rays with a warm one too), the frame at the host's pace, as it
runs.  Cases: config 3 (260,642 triangles, 1920x1056 = 2,027,520 rays), K1 on
the default (``sah_free``) and the Karras tree, primary and shadow rays; K1c
against K1 in turns (K1, K1c, K1c, K1) on the same rays of the default tree,
where the checkout has ``compress_tables4`` (``k1c``); K5
at 262,144 and 65,280 int32 (the sort's histograms at 1 M keys and at 260,642
triangles), in turns with ``torch.cumsum``; the frame with shadows on the
default tree.  Each K1 and K5 case carries a digest of what the kernel
returned (t, tri, u, v bits and the records popped per ray; the scan's
output), so two checkouts' runs show whether their kernels agree bit for
bit.  Prints one JSON line, with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

PKG_NAME = "unitysimpleraytracing_tpu_torch"
THIS_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 1920, 1056
SCAN_SIZES = (262144, 65280)


def digest(*tensors) -> str:
    """sha256 of the tensors' bytes, in order (first 16 hex digits)."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def import_package(root: str):
    """The package under ``root``, and this checkout's profiling module."""
    root = os.path.abspath(root)
    if not os.path.isdir(os.path.join(root, PKG_NAME)):
        raise ValueError(f"no {PKG_NAME} package under {root}")
    loaded = sys.modules.get(PKG_NAME)
    if loaded is not None and os.path.dirname(os.path.dirname(loaded.__file__)) != root:
        raise RuntimeError(f"{PKG_NAME} is already imported from elsewhere: run this file "
                           "by its path, not with -m")
    sys.path.insert(0, root)
    import unitysimpleraytracing_tpu_torch as rt

    spec = importlib.util.spec_from_file_location(
        "_kernel_ab_profiling", os.path.join(THIS_PKG, "utils", "profiling.py"))
    profiling = sys.modules[spec.name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(profiling)
    return rt, profiling


def _in_turns(timer, fns: dict, iters: int, **kw) -> dict:
    """Median ms of each call, in the order A, B, ..., B, A."""
    order = list(fns) + list(fns)[::-1]
    out = {k: [] for k in fns}
    for k in order:
        out[k].append(timer.median_ms(fns[k], iters=iters, **kw))
    return out


def _compressed_in_turns(timer, trace_bvh4, table, o, d, thr, iters, **kw) -> dict:
    """K1c against K1 on the same rays, in turns, with K1c's digest and the
    bytes of the two tables."""
    comp = trace_bvh4.compress_tables4(table)
    got, steps = trace_bvh4.traverse_bvh4(comp, o, d, anyhit_thresh=thr, count_steps=True)
    fns = {"k1": lambda: trace_bvh4.traverse_bvh4(table, o, d, anyhit_thresh=thr),
           "k1c": lambda: trace_bvh4.traverse_bvh4(comp, o, d, anyhit_thresh=thr)}
    turns = _in_turns(timer, fns, iters, **kw)
    return {"records": int(comp.shape[0]), "pops": int(steps.sum()),
            "table_bytes": {"k1": table.numel() * 4, "k1c": comp.numel() * 4},
            "digest": digest(got.t.view(torch.int32), got.tri, got.u.view(torch.int32),
                             got.v.view(torch.int32), steps),
            "ms_cold_l2_in_turns": turns,
            "k1c_over_k1": sum(turns["k1c"]) / sum(turns["k1"])}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(THIS_PKG),
                    help="checkout whose package is measured (default: this one)")
    ap.add_argument("--iters", type=int, default=7)
    ap.add_argument("--out", help="file to append the JSON line to")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_ab measures on a CUDA device; none is available")
    rt, profiling = import_package(args.root)
    from unitysimpleraytracing_tpu_torch.core.camera import generate_rays
    from unitysimpleraytracing_tpu_torch.ops import dispatch, scan, trace_bvh4
    from unitysimpleraytracing_tpu_torch.pipeline import render
    from unitysimpleraytracing_tpu_torch.utils import kernel_build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    timer = profiling.Timer()
    cold = dict(cold=True, queued=True)
    line = {"root": os.path.abspath(args.root), "nvidia_smi": smi,
            "device": torch.cuda.get_device_name(0), "iters": args.iters}

    # ---- K1 on config 3 ------------------------------------------------------
    scene = rt.build_scene(rt.terrain_mesh(res=362, size=160.0, amplitude=20.0, seed=1))
    cam = rt.make_camera(eye=(110.0, 90.0, 140.0), target=(0.0, 0.0, 0.0), width=W, height=H)
    o, d = generate_rays(cam)
    o = dispatch._tile_major(o, H, W, 32).contiguous()
    d = dispatch._tile_major(d, H, W, 32).contiguous()
    trees = {"default": rt.build_bvh(scene), "karras": rt.build_bvh(scene, builder="karras")}
    line["k1"] = {}
    for tree, bvh in trees.items():
        table = trace_bvh4.prepare_tables4(scene, bvh)
        hits = rt.render_hits(scene, bvh, cam)
        so, sd, bound = render.shadow_rays(scene, bvh, hits, cam)
        bo, bd, thr, _ = dispatch.occlusion_rays(
            scene, dispatch._tile_major(so, H, W, 32), dispatch._tile_major(sd, H, W, 32),
            origin_bound=bound)
        cases = {"primary": (o, d, None), "shadow": (bo.contiguous(), bd.contiguous(), thr)}
        line["k1"][tree] = {}
        for rays, (ro, rd, rthr) in cases.items():
            got, steps = trace_bvh4.traverse_bvh4(table, ro, rd, anyhit_thresh=rthr,
                                                  count_steps=True)
            call = (lambda ro=ro, rd=rd, rthr=rthr:
                    trace_bvh4.traverse_bvh4(table, ro, rd, anyhit_thresh=rthr))
            case = {"records": int(table.shape[0]), "pops": int(steps.sum()),
                    "digest": digest(got.t.view(torch.int32), got.tri, got.u.view(torch.int32),
                                     got.v.view(torch.int32), steps),
                    "ms_cold_l2": timer.median_ms(call, iters=args.iters, **cold)}
            if rays == "primary":
                case["ms_warm_l2"] = timer.median_ms(call, iters=args.iters, queued=True)
            line["k1"][tree][rays] = case
            if tree == "default" and hasattr(trace_bvh4, "compress_tables4"):
                line.setdefault("k1c", {})[rays] = _compressed_in_turns(
                    timer, trace_bvh4, table, ro, rd, rthr, args.iters, **cold)

    # ---- the frame with shadows, default tree -----------------------------------
    tex = rt.solid_texture((0.8, 0.7, 0.6, 1.0))
    bg = np.asarray([0.1, 0.1, 0.12], np.float32)
    line["frame_with_shadows_default_tree_ms"] = timer.median_ms(
        lambda: rt.render_frame(scene, trees["default"], cam, tex, bg, shadows=True),
        iters=max(args.iters, 5))
    del trees, scene, table, hits, so, sd, bo, bd, thr

    # ---- K5 against torch.cumsum -------------------------------------------------
    rng = np.random.default_rng(5)
    line["k5"] = {}
    for size in SCAN_SIZES:
        x = torch.from_numpy(rng.integers(0, 1025, size=size).astype(np.int32)).cuda()
        before = scan.exclusive_scan.device_launches
        got = scan.exclusive_scan(x)
        launches = scan.exclusive_scan.device_launches - before
        if not torch.equal(got, scan.exclusive_scan_plain(x)):
            raise AssertionError(f"K5 differs from its plain version at {size}")
        turns = _in_turns(timer, {"exclusive_scan": lambda: scan.exclusive_scan(x),
                                  "torch.cumsum": lambda: torch.cumsum(x, 0, dtype=torch.int32)},
                          args.iters, **cold)
        line["k5"][str(size)] = {"device_launches_per_call": launches, "digest": digest(got),
                                 "ms_cold_l2_in_turns": turns,
                                 "bound_ms": 2 * 4 * size / profiling.PEAK_BYTES_PER_S * 1e3}

    line["ptxas"] = {name: [ln.strip() for ln in kernel_build.build_log(name).splitlines()
                            if "registers" in ln or "spill" in ln or "stack frame" in ln]
                     for name in ("trace_bvh4", "scan")}
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return line


if __name__ == "__main__":
    main(sys.argv[1:])
