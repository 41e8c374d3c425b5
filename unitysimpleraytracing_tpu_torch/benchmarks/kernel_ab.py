"""K1 (BVH4 traversal), K1c (its compressed-record variant), K2 (binary-record
traversal), K5 (exclusive scan) and the frame with shadows, timed through the
package's public entry points, to compare two checkouts on one card in turns.

    python unitysimpleraytracing_tpu_torch/benchmarks/kernel_ab.py \\
        [--root DIR] [--iters 7] [--cases k1,k2,k2_vs_k1,frame,k5] [--out FILE]

``--root DIR`` imports ``unitysimpleraytracing_tpu_torch`` from DIR (for
example a parent commit unpacked with ``git archive`` into a git-ignored
directory) instead of from the checkout this file lies in, so DIR's kernels
are built from DIR's sources by DIR's own code.  Run it once per checkout, in
turns (parent, change, change, parent), in one call to the card.  Run it by
its path, not with ``-m``, so the package is imported from ``--root``.
``--cases`` picks what is measured (default: all).

Timing: this file's own checkout's `utils/profiling.Timer`, loaded from its
path so that an older package can be measured: CUDA events, the device held
while the host enqueues, median of ``--iters``; kernels with a cold L2 and a
warm one, the frame at the host's pace, as it runs.  Cases:

- ``k1``, ``k2``: config 3 (260,642 triangles, 1920x1056 = 2,027,520 rays),
  each kernel on the default (``sah_free``) and the Karras tree, primary and
  shadow rays, with records popped and the lanes' efficiency in 32-ray
  warps; with ``k1``, K1c against K1 in turns (K1, K1c, K1c, K1) on the same
  rays of the default tree, where the checkout has ``compress_tables4``;
- ``k2_vs_k1``: K1 against K2 in turns (K1, K2, K2, K1) on the same
  tile-major rays of four scenes: the 65,522-triangle terrain at 512x512, the
  65,536-triangle soup with 65,536 random rays, config 3 on the default and
  the Karras tree, and 1,048,352 triangles at 512x512 (the default tree,
  primary rays and, on the terrains, shadow rays);
- ``frame``: the frame with shadows on the default tree;
- ``k5``: K5 at 262,144 and 65,280 int32 (the sort's histograms at 1 M keys
  and at 260,642 triangles), in turns with ``torch.cumsum``.

Each K1, K2 and K5 case carries a digest of what the kernel returned (t,
tri, u, v bits and the records popped per ray; the scan's output), so two
checkouts' runs show whether their kernels agree bit for bit.  Prints one
JSON line, with the card's name and power limit and the compiler's register,
spill and stack-frame report for each kernel it built.
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
CASES = ("k1", "k2", "k2_vs_k1", "frame", "k5")
# Kernels whose compiler report (registers, spill, stack frame) the line
# carries; one not built in the run reports nothing.
PTXAS = ("trace_bvh4", "trace_bvh2", "scan")


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


def _traversal_case(timer, profiling, kernel, table, ro, rd, rthr, iters, cold) -> dict:
    """One traversal kernel on one ray set: records popped, the lanes'
    efficiency in 32-ray warps, a digest of t / tri / u / v bits and the
    records popped per ray, and the kernel's time with a cold and a warm L2."""
    got, steps = kernel(table, ro, rd, anyhit_thresh=rthr, count_steps=True)
    call = lambda: kernel(table, ro, rd, anyhit_thresh=rthr)  # noqa: E731
    pops = int(steps.sum())
    return {"records": int(table.shape[0]), "pops": pops,
            "records_per_ray": pops / steps.numel(),
            "warp_lane_efficiency": profiling.warp_lane_efficiency(steps),
            "digest": digest(got.t.view(torch.int32), got.tri, got.u.view(torch.int32),
                             got.v.view(torch.int32), steps),
            "ms_cold_l2": timer.median_ms(call, iters=iters, **cold),
            "ms_warm_l2": timer.median_ms(call, iters=iters, queued=True)}


def random_rays(n: int, seed: int, bound: float):
    """``n`` rays from uniform origins in a cube of half-width ``bound``
    along normalised Gaussian directions, on the card."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-bound, bound, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o).cuda(), torch.from_numpy(d).cuda()


def frame_rays(rt, scene, bvh, cam, w, h) -> dict:
    """Tile-major primary rays of a camera, and the shadow rays (any-hit)
    of this tree's hits: {"primary": (o, d, None), "shadow": (o, d, thr)}."""
    from unitysimpleraytracing_tpu_torch.core.camera import generate_rays
    from unitysimpleraytracing_tpu_torch.ops import dispatch
    from unitysimpleraytracing_tpu_torch.pipeline import render

    o, d = generate_rays(cam)
    so, sd, bound = render.shadow_rays(scene, bvh, rt.render_hits(scene, bvh, cam), cam)
    bo, bd, thr, _ = dispatch.occlusion_rays(
        scene, dispatch._tile_major(so, h, w, 32), dispatch._tile_major(sd, h, w, 32),
        origin_bound=bound)
    return {"primary": (dispatch._tile_major(o, h, w, 32).contiguous(),
                        dispatch._tile_major(d, h, w, 32).contiguous(), None),
            "shadow": (bo.contiguous(), bd.contiguous(), thr)}


def _k2_against_k1(timer, trace_bvh4, trace_bvh2, scene, bvh, rays, iters, cold) -> dict:
    """K1 and K2 in turns (K1, K2, K2, K1) on the same rays of one tree:
    records popped by each, cold-L2 times, and the ratio K2 / K1."""
    t4, t2 = trace_bvh4.prepare_tables4(scene, bvh), trace_bvh2.prepare_tables(scene, bvh)
    K1, K2 = trace_bvh4.traverse_bvh4, trace_bvh2.traverse_bvh2
    out = {"triangles": int(scene.count), "capacity": int(bvh.capacity),
           "records": {"k1": int(t4.shape[0]), "k2": int(t2.shape[0])}}
    for name, (ro, rd, rthr) in rays.items():
        _, s1 = K1(t4, ro, rd, anyhit_thresh=rthr, count_steps=True)
        _, s2 = K2(t2, ro, rd, anyhit_thresh=rthr, count_steps=True)
        turns = _in_turns(timer, {"k1": lambda: K1(t4, ro, rd, anyhit_thresh=rthr),
                                  "k2": lambda: K2(t2, ro, rd, anyhit_thresh=rthr)},
                          iters, **cold)
        out[name] = {"rays": int(ro.shape[0]),
                     "records_per_ray": {"k1": int(s1.sum()) / ro.shape[0],
                                         "k2": int(s2.sum()) / ro.shape[0]},
                     "ms_cold_l2_in_turns": turns,
                     "k2_over_k1": sum(turns["k2"]) / sum(turns["k1"])}
    return out


def _config3_tree(line, cases, timer, profiling, rt, trace_bvh4, trace_bvh2, scene, cam,
                  tree, bvh, iters, cold) -> None:
    """The ``k1``, ``k2`` and ``k2_vs_k1`` cases of one config-3 tree, into
    ``line``."""
    rays = frame_rays(rt, scene, bvh, cam, W, H)
    if "k1" in cases:
        table = trace_bvh4.prepare_tables4(scene, bvh)
        line.setdefault("k1", {})[tree] = {
            name: _traversal_case(timer, profiling, trace_bvh4.traverse_bvh4, table, *r,
                                  iters, cold) for name, r in rays.items()}
        if tree == "default" and hasattr(trace_bvh4, "compress_tables4"):
            line["k1c"] = {name: _compressed_in_turns(timer, trace_bvh4, table, *r, iters,
                                                      **cold) for name, r in rays.items()}
    if "k2" in cases:
        table = trace_bvh2.prepare_tables(scene, bvh)
        line.setdefault("k2", {})[tree] = {
            name: _traversal_case(timer, profiling, trace_bvh2.traverse_bvh2, table, *r,
                                  iters, cold) for name, r in rays.items()}
    if "k2_vs_k1" in cases:
        line.setdefault("k2_vs_k1", {})[f"config3_{tree}_tree"] = _k2_against_k1(
            timer, trace_bvh4, trace_bvh2, scene, bvh, rays, iters, cold)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(THIS_PKG),
                    help="checkout whose package is measured (default: this one)")
    ap.add_argument("--iters", type=int, default=7)
    ap.add_argument("--cases", default=",".join(CASES),
                    help=f"comma-separated subset of {','.join(CASES)}")
    ap.add_argument("--out", help="file to append the JSON line to")
    args = ap.parse_args(argv)
    cases = args.cases.split(",")
    unknown = sorted(set(cases) - set(CASES))
    if unknown:
        raise ValueError(f"unknown cases {unknown}; choose from {CASES}")
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_ab measures on a CUDA device; none is available")
    rt, profiling = import_package(args.root)
    from unitysimpleraytracing_tpu_torch.ops import scan, trace_bvh2, trace_bvh4
    from unitysimpleraytracing_tpu_torch.utils import kernel_build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    timer = profiling.Timer()
    cold = dict(cold=True, queued=True)
    line = {"root": os.path.abspath(args.root), "nvidia_smi": smi,
            "device": torch.cuda.get_device_name(0), "iters": args.iters, "cases": cases}

    # ---- config 3: K1, K2, K2 against K1, the frame -----------------------------
    traversal = {"k1", "k2", "k2_vs_k1"} & set(cases)
    if traversal or "frame" in cases:
        scene = rt.build_scene(rt.terrain_mesh(res=362, size=160.0, amplitude=20.0, seed=1))
        cam = rt.make_camera(eye=(110.0, 90.0, 140.0), target=(0.0, 0.0, 0.0),
                             width=W, height=H)
        trees = {"default": rt.build_bvh(scene)}
        if traversal:
            trees["karras"] = rt.build_bvh(scene, builder="karras")
            for tree, bvh in trees.items():
                _config3_tree(line, cases, timer, profiling, rt, trace_bvh4, trace_bvh2,
                              scene, cam, tree, bvh, args.iters, cold)
        if "frame" in cases:
            tex = rt.solid_texture((0.8, 0.7, 0.6, 1.0))
            bg = np.asarray([0.1, 0.1, 0.12], np.float32)
            line["frame_with_shadows_default_tree_ms"] = timer.median_ms(
                lambda: rt.render_frame(scene, trees["default"], cam, tex, bg, shadows=True),
                iters=max(args.iters, 5))
        del trees, scene

    # ---- K2 against K1 on the other three scenes (default trees) ------------------
    if "k2_vs_k1" in cases:
        for label, mesh, eye in (
                ("terrain_65k_512x512",
                 lambda: rt.terrain_mesh(res=182, size=80.0, amplitude=9.0, seed=0),
                 (55.0, 45.0, 70.0)),
                ("soup_65k_random_rays", lambda: rt.random_triangle_soup(65536, seed=0), None),
                ("terrain_1m_512x512",
                 lambda: rt.terrain_mesh(res=725, size=300.0, amplitude=30.0, seed=0),
                 (210.0, 170.0, 260.0))):
            # Capacity padded to 32, not 1024: 1,048,352 triangles padded to
            # 2^20 would pass the binary records' 20-bit ids.
            scene = rt.build_scene(mesh(), pad_multiple=32)
            bvh = rt.build_bvh(scene)
            if eye is None:
                rays = {"primary": (*random_rays(65536, seed=1, bound=60.0), None)}
            else:
                cam = rt.make_camera(eye=eye, target=(0.0, 0.0, 0.0), width=512, height=512)
                rays = frame_rays(rt, scene, bvh, cam, 512, 512)
            line["k2_vs_k1"][label] = _k2_against_k1(
                timer, trace_bvh4, trace_bvh2, scene, bvh, rays, args.iters, cold)
            del scene, bvh, rays

    # ---- K5 against torch.cumsum -------------------------------------------------
    rng = np.random.default_rng(5)
    for size in (SCAN_SIZES if "k5" in cases else ()):
        x = torch.from_numpy(rng.integers(0, 1025, size=size).astype(np.int32)).cuda()
        before = scan.exclusive_scan.device_launches
        got = scan.exclusive_scan(x)
        launches = scan.exclusive_scan.device_launches - before
        if not torch.equal(got, scan.exclusive_scan_plain(x)):
            raise AssertionError(f"K5 differs from its plain version at {size}")
        turns = _in_turns(timer, {"exclusive_scan": lambda: scan.exclusive_scan(x),
                                  "torch.cumsum": lambda: torch.cumsum(x, 0, dtype=torch.int32)},
                          args.iters, **cold)
        line.setdefault("k5", {})[str(size)] = {
            "device_launches_per_call": launches, "digest": digest(got),
            "ms_cold_l2_in_turns": turns,
            "bound_ms": 2 * 4 * size / profiling.PEAK_BYTES_PER_S * 1e3}

    line["ptxas"] = {name: [ln.strip() for ln in kernel_build.build_log(name).splitlines()
                            if "registers" in ln or "spill" in ln or "stack frame" in ln]
                     for name in PTXAS}
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return line


if __name__ == "__main__":
    main(sys.argv[1:])
