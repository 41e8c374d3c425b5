#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR] [--profile]

Drives the port's main paths through the public entry points, at the sizes
the repo calls real (260,642 triangles at 1920x1056 with shadow rays;
1,048,352 triangles as one tree; 4,193,408 triangles in chunks):

- the static-scene frame: procedural mesh → ``build_scene`` → ``build_bvh`` →
  BVH4 record table → CUDA traversal kernel → shade → compose → PNG;
- the build's radix-sort path: ``build_bvh(sort_impl="cuda")`` (one count of
  all four digits, the exclusive scan of the counts, four look-back passes
  that rank and move keys and values) and ``build_bvh(validate=True)``
  (every validator, every digit pass of both decomposed sort engines);
- the dynamic-scene paths on the same 260,642-triangle scene: ``render_frames``
  (a group of orbit frames as one ray batch), ``make_animated_renderer``
  (deform → refit → table update → trace, per frame), both through the BVH4
  kernel and through the binary-record kernel (``impl="cuda2"``), and the
  shared-stack packet engine against the per-ray oracle;
- the measurement path: the primitive-cost probes P1 and P2 through their
  entry point (``benchmarks/kernel_probe.main`` at ``--iters 20000``);
- the default build: ``build_bvh(scene)`` with no ``builder`` (free-order
  sweep SAH), ``"sah"`` and ``"karras"`` in turns on the 260,642-triangle
  scene, ``validate=True`` on the default tree, frames and both traversal
  kernels on all three trees, and one ``"sah"`` build of 1,048,352 triangles;
- K1's compressed-record variant (K1c) on the 260,642-triangle default tree:
  ``trace_rays(..., tables=compress_tables4(prepare_tables4(...)))``;
- large scenes: 4,193,408 triangles through ``build_bvh_chunked`` (26 chunks)
  and ``render_frame_chunked`` at 1920x1056 with shadows; at 1,048,352
  triangles one tree against chunks (the CLI's switch point), binary chunk
  records, and a save → load → trace round trip of the chunked checkpoint;
- the multi-device layer (``benchmarks/dist_path.run``): the dp, all-gather,
  ring and shuffle engines on a one-process NCCL group and on 8 spawned gloo
  ranks sharing the card, over BASELINE config 5's 999,698 triangles at
  4,096 and 1,048,576 rays, held to one trace of the whole scene; the
  build/trace pipeline on two of those ranks over the 260,642-triangle
  deforming mesh; ``multihost.initialize`` and the host mesh;
- the host-side modules (``aux_path``): ``utils/resilience.device_healthcheck``,
  ``utils/debug.probe_kernel`` around K1, the C++ OBJ parser of ``native/``
  against the Python one on the 65,522-triangle terrain written as an OBJ,
  and the CLI's ``--gizmo --gizmo-tris`` render of that OBJ against
  ``utils/visualize.draw_aabbs`` over its plain frame;
- the bench entry point (``benchmarks/bench.py``, ``bench.py``'s rows in its
  schema) once, in its own process, its JSON line checked (``bench``);
- the traversal kernels K1, K2 and K1c at config 2 (65,522 triangles,
  512x512, the default tree) through ``render_hits`` and ``trace_rays``,
  held to the JAX package's committed answer under the crack rule
  (``parity_scale``);
- the shadowed frame at configs 2 and 3 (``render_frame(..., shadows=True)``,
  K1 nearest-hit and any-hit, K2's primary hits at config 3) and the
  animated frame of config 4's deforming mesh (refit, K1), held to the JAX
  package's committed answers under the crack, occlusion and frame rules
  (``parity_frame``).

It builds the hand-written kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, shows by launch counts
that each path went through its kernels, checks frames against the golden
images, and times every stage with CUDA events.

``--out DIR`` is where the rendered PNG goes (default ``build/chip_smoke``
under this checkout).  ``--profile`` adds an A/B of the forms of one 2 M-row
texel gather; without that flag it is skipped.  For where a frame, a build or
a load spends its time, trace the benchmark instead: ``python3 rtbench/run.py
--workload <cell> --seed <n> --seconds <s> --trace 1`` reads the program's
own spans from a ``torch.profiler`` slice.

It needs a CUDA device and fails without one; nothing here falls back to the
CPU and any failed phase ends the run with a non-zero exit code.  Each phase
prints one JSON line; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from unitysimpleraytracing_tpu_torch.benchmarks.kernel_ab import frame_rays, random_rays
from unitysimpleraytracing_tpu_torch.utils.profiling import (
    LOADED_BYTES_PER_LEAF_RECORD2, LOADED_BYTES_PER_LEAF_TEST, LOADED_BYTES_PER_POP,
    LOADED_BYTES_PER_POP2, LOADED_BYTES_PER_POP_C, OPS_PER_LEAF_TEST2, OPS_PER_POP2,
    PEAK_BYTES_PER_S, PEAK_F32_NOFMA_OPS_PER_S, PEAK_F32_OPS_PER_S, RECORD_BYTES2,
    RECORD_BYTES_C, Timer, loaded_bytes, roofline_ms, warp_lane_efficiency,
)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(HERE, "tests", "golden")

MAX_FLOAT = np.float32(3.4028234663852886e38)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def np_hits(h) -> SimpleNamespace:
    """A HitRecord's fields as numpy arrays, for the parity helpers."""
    return SimpleNamespace(
        **{k: getattr(h, k).detach().cpu().numpy() for k in ("t", "tri", "u", "v")}
    )


def engine_of(module):
    """(kernel wrapper, plain version) of ops/trace_bvh4 or ops/trace_bvh2."""
    if module.KERNEL_NAME == "trace_bvh4":
        return module.traverse_bvh4, module.traverse_bvh4_plain
    return module.traverse_bvh2, module.traverse_bvh2_plain


def compare_kernel_with_plain(name, module, parity, table, o, d,
                              t_init=None, thresh=None, work=None, timer=None):
    """Kernel against plain version on the same CUDA tensors.  Tolerance:
    identical hit masks; t, u, v bit-identical where tri agrees; every tri
    disagreement an exact-t tie (|dt| <= 4e-6 |t|); the records popped per
    ray (``steps``) identical.  With ``timer`` the plain run is timed
    (``plain_ms``); ``work`` is filled by another plain run, not timed.
    Returns the stats, both results and the kernel's steps."""
    kernel, plain = engine_of(module)
    got, steps = kernel(table, o, d, t_init=t_init, anyhit_thresh=thresh, count_steps=True)
    torch.cuda.synchronize()
    kept = {}

    def run_plain():
        kept["r"] = plain(table, o, d, t_init=t_init, anyhit_thresh=thresh, count_steps=True)

    plain_ms = timer.median_ms(run_plain, iters=1, warmup=0) if timer else run_plain()
    if work is not None:
        plain(table, o, d, t_init=t_init, anyhit_thresh=thresh, work=work)
    torch.cuda.synchronize()
    want, want_steps = kept["r"]
    stats = parity.assert_hit_parity(np_hits(got), np_hits(want), exact=True)
    assert torch.equal(steps, want_steps), f"{name}: records popped per ray differ"
    stats["steps_bit_identical"] = True
    stats["max_abs_err"] = max(stats["max_abs_dt"], stats["max_abs_duv"])
    stats["case"] = name
    if timer:
        stats["plain_ms"] = plain_ms
    return stats, got, want, steps


def traversal_on_tree(timer, parity, module, table, rays, n_rays):
    """One traversal kernel (``module`` = ops/trace_bvh4 or ops/trace_bvh2)
    over one tree at the main path's shapes.  ``rays`` = {"primary": (o, d,
    None), "shadow": (o, d, any-hit thresholds)}.  For each: the kernel
    against its plain version (`compare_kernel_with_plain`, the plain run
    timed once), the work this run's data needs (pops, leaf tests, distinct
    records), the lane efficiency of 32-ray warps, the record bytes the
    kernel loads as its code reads them, the roofline bound with operations
    at the no-FMA rate, and the kernel's time with the L2 cold (and warm, on
    primary rays), CUDA events with the device held while the host enqueues,
    median of 7."""
    kernel, _ = engine_of(module)
    two = module.KERNEL_NAME == "trace_bvh2"
    compressed = table.shape[1] == 52  # K1c: trace_bvh4.compress_tables4 records
    per_pop, per_leaf = ((LOADED_BYTES_PER_POP2, LOADED_BYTES_PER_LEAF_RECORD2) if two
                         else (LOADED_BYTES_PER_POP_C if compressed else LOADED_BYTES_PER_POP,
                               LOADED_BYTES_PER_LEAF_TEST))
    roof_kw = (dict(record_bytes=RECORD_BYTES2, ops_per_pop=OPS_PER_POP2,
                    ops_per_leaf_test=OPS_PER_LEAF_TEST2) if two
               else dict(record_bytes=RECORD_BYTES_C) if compressed else {})
    out = {}
    for name, (o, d, thr) in rays.items():
        work = {}
        st, _, _, steps = compare_kernel_with_plain(
            f"{module.KERNEL_NAME}{' compressed' if compressed else ''}: {name} rays",
            module, parity, table, o, d,
            thresh=thr, work=work, timer=timer)
        pops, leaf = int(steps.sum()), work["leaf_tests"]
        ms = timer.median_ms(lambda: kernel(table, o, d, anyhit_thresh=thr),
                             iters=7, cold=True, queued=True)
        # K2 reads both triangles of a record that tests a leaf child at once.
        loaded = loaded_bytes(pops, work["leaf_records"] if two else leaf, per_pop, per_leaf)
        out[name] = {
            "compare": st, "ms_cold_l2": ms, "plain_ms": st.pop("plain_ms"),
            "pops": pops, "records_per_ray": pops / n_rays, "max_pops": int(steps.max()),
            **work, "warp_lane_efficiency": warp_lane_efficiency(steps),
            "loaded_bytes": loaded, "loaded_bytes_per_s": loaded / ms * 1e3,
            **roofline_ms(n_rays, 0, thr is not None, work["records_visited"], pops, leaf,
                          peak_ops=PEAK_F32_NOFMA_OPS_PER_S, **roof_kw),
        }
        if name == "primary":
            out[name]["ms_warm_l2"] = timer.median_ms(
                lambda: kernel(table, o, d, anyhit_thresh=thr), iters=7, queued=True)
    return out


def max_abs_diff(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest absolute difference of two tensors of one shape and dtype."""
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
    return float((got.double() - want.double()).abs().max())


def bvh_bits_equal(parity, got, want, what: str) -> int:
    """Every array of two Bvh containers bit for bit; returns the array count."""
    import dataclasses

    arrays = 0
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(g, torch.Tensor):
            parity.assert_bits_equal(g.cpu().numpy(), w.cpu().numpy(), f"{what}: {f.name}")
            arrays += 1
        else:
            assert g == w, (what, f.name)
    return arrays


def run_sort_slice(rt, timer, smi, main_image, tex, bg, W, H):
    """The build's radix-sort path: K3 (the count of all four digits, and its
    one-digit per-block form ``digit_histogram``), K5 (the scan of the
    counts) and K4 (the look-back pass that ranks and moves keys and values,
    and its rank-only form ``digit_rank``) against their plain versions on
    every output, then ``build_bvh(sort_impl="cuda")`` and
    ``build_bvh(validate=True)`` at full size.  Emits the phases
    ``sort_kernels_vs_plain`` and ``sort_path`` and returns the three
    entries of the ``kernels`` line."""
    from unitysimpleraytracing_tpu_torch import constants as C
    from unitysimpleraytracing_tpu_torch.ops import scan, sort, sort_radix_cuda as R
    from unitysimpleraytracing_tpu_torch.utils import parity, validate

    K5 = scan.exclusive_scan
    BLOCK = R.BLOCK
    rng = np.random.default_rng(2)

    scene_260k = rt.build_scene(rt.terrain_mesh(res=362, size=160.0, amplitude=20.0, seed=1))
    scene_1m = rt.build_scene(rt.terrain_mesh(res=725, size=300.0, amplitude=30.0, seed=0))
    assert scene_260k.count == 260642 and scene_1m.count == 1048352
    assert scene_1m.capacity == 1 << 20

    def dev_keys(arr):
        return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int64)).cuda()

    def kind_keys(kind, n):
        r = np.random.default_rng(n)
        return dev_keys({
            "random": lambda: r.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.int64),
            "duplicates": lambda: r.choice([0, 1, 5, 1 << 29, (1 << 30) - 1], size=n),
            "equal": lambda: np.full(n, 0x12345678),
            "padding": lambda: np.full(n, C.KEY_PADDING),
        }[kind]())

    # ---- sort_kernels_vs_plain ------------------------------------------
    err = dict.fromkeys(("digit_counts", "digit_histogram", "exclusive_scan", "digit_pass",
                         "digit_rank"), 0.0)

    def hold(kernel, got, want, what):
        assert got.dtype == want.dtype and torch.equal(got, want), \
            f"{kernel} differs from its plain version: {what}"
        err[kernel] = max(err[kernel], max_abs_diff(got, want))

    def check_sort(keys, values, what):
        """The count, its scan and the four passes, every output against the
        plain versions (and, on whole blocks, the per-block forms), the
        result against the stable torch.sort."""
        counts = R.digit_counts(keys)
        torch.cuda.synchronize()
        hold("digit_counts", counts, R.digit_counts_plain(keys), what)
        bases = K5(counts)
        hold("exclusive_scan", bases, scan.exclusive_scan_plain(counts), what)
        k, v = keys, values
        for shift in R.SHIFTS:
            got = R.digit_pass(k, v, bases, shift, observe=True)
            torch.cuda.synchronize()
            want = R.digit_pass_plain(k, v, bases, shift)
            for name, g, w in zip(("keys_out", "values_out", "dst", "hist_t", "scanned"), got, want):
                hold("digit_pass", g, w, f"{what}, shift {shift}, {name}")
            if k.shape[0] % BLOCK == 0:
                hist_t = R.digit_histogram(k, shift)
                hold("digit_histogram", hist_t, R.digit_histogram_plain(k, shift),
                     f"{what}, shift {shift}")
                dst = R.digit_rank(k, got[4], shift)
                hold("digit_rank", dst, R.digit_rank_plain(k, got[4], shift),
                     f"{what}, shift {shift}")
                assert torch.equal(hist_t, got[3]) and torch.equal(dst, got[2]), what
            k, v = got[0], got[1]
        want_k, perm = torch.sort(keys, stable=True)
        assert torch.equal(k, want_k) and torch.equal(v, values[perm]), what

    cases = []
    for name, keys in (
        ("morton keys of the 260,642-triangle scene (capacity 261,120)", scene_260k.morton),
        ("morton keys of the 1,048,352-triangle scene (capacity 1,048,576)", scene_1m.morton),
        ("2^20 random 32-bit keys", kind_keys("random", 1 << 20)),
    ):
        check_sort(keys, torch.arange(keys.shape[0], dtype=torch.int32, device="cuda"), name)
        cases.append({"case": name, "keys": int(keys.shape[0]), "passes": 4,
                      "bit_identical": True})
    # The acceptance list: every size, every key kind, all four passes.
    for n in (1, 1023, 1024, 1025, 1 << 20, (1 << 22) + 3):
        for kind in ("random", "duplicates", "equal", "padding"):
            values = torch.from_numpy(rng.permutation(n).astype(np.int32)).cuda()
            check_sort(kind_keys(kind, n), values, f"{kind} n={n}")
            cases.append({"case": f"{kind} n={n}", "keys": n, "passes": 4,
                          "bit_identical": True})
    for n in (1, 1023, 1025, 5000):
        keys = kind_keys("random", n)
        values = torch.arange(n, dtype=torch.int32, device="cuda")
        gk, gv = sort.sort_key_val(keys, values, impl="cuda")
        wk, wv = sort.sort_key_val(keys, values, impl="torch")
        assert torch.equal(gk, wk) and torch.equal(gv, wv), f"ragged n={n}"
        cases.append({"case": f"ragged n={n} through sort_key_val(impl='cuda')",
                      "keys": n, "bit_identical": True})
    # The scan alone: the old histogram's shape, two levels of totals, int64, float32.
    scan_cases = []
    for name, x in (
        ("256 x 1024 histogram shape, int32",
         torch.from_numpy(rng.integers(0, 1025, size=256 * 1024).astype(np.int32)).cuda()),
        ("2^20 + 12,345 elements (two levels of totals), int32",
         torch.from_numpy(rng.integers(0, 9, size=(1 << 20) + 12345).astype(np.int32)).cuda()),
        ("2^22 elements, int64, totals beyond 2^32",
         torch.from_numpy(rng.integers(0, 1 << 40, size=1 << 22)).cuda()),
    ):
        before = K5.device_launches
        got = K5(x)
        levels = K5.device_launches - before
        want = scan.exclusive_scan_plain(x)
        hold("exclusive_scan", got, want, name)
        scan_cases.append({"case": name, "elements": int(x.shape[0]),
                           "device_launches": levels, "bit_identical": True})
    assert [c["device_launches"] for c in scan_cases] == [1, 1, 1]
    xf = rng.normal(size=(1 << 20) + 77).astype(np.float32)
    got = K5(torch.from_numpy(xf).cuda()).cpu().numpy().astype(np.float64)
    want = scan.exclusive_scan_reference(xf.astype(np.float64))
    sum_abs = np.maximum(scan.exclusive_scan_reference(np.abs(xf).astype(np.float64)), 1.0)
    float_err = float(np.max(np.abs(got - want) / sum_abs))
    assert float_err <= 1e-5, f"float32 scan off by {float_err} of the running sum"
    plain_f = scan.exclusive_scan_plain(torch.from_numpy(xf).cuda()).cpu().numpy()
    float_err_plain = float(np.max(np.abs(got - plain_f) / sum_abs))
    assert float_err_plain <= 1e-5
    scan_cases.append({"case": "2^20 + 77 normal float32", "elements": int(xf.shape[0]),
                       "max_err_over_running_sum_of_magnitudes_vs_float64": float_err,
                       "same_vs_plain_cumsum": float_err_plain})

    # Times at the 1 M-key shape (the 1,048,352-triangle scene's keys and
    # triangle ids), CUDA events, median of 5 after a warm-up, cold L2, the
    # device held while the host enqueues.
    keys, values = scene_1m.morton, scene_1m.tri_index
    n = keys.shape[0]
    nblocks = n // BLOCK
    counts = R.digit_counts(keys)
    bases = K5(counts)
    _, _, dst, hist_t, scanned = R.digit_pass(keys, values, bases, 0, observe=True)
    shifts_t = torch.tensor(R.SHIFTS, device="cuda")
    rows_t = torch.arange(C.NUM_PASSES, device="cuda") * C.NUM_BUCKETS

    def cold(fn, iters=5, queued=True):
        return timer.median_ms(fn, iters=iters, cold=True, queued=queued)

    def library_counts():
        return torch.bincount((((keys[:, None] >> shifts_t) & 255) + rows_t).reshape(-1),
                              minlength=C.NUM_PASSES * C.NUM_BUCKETS)

    def library_pass(shift=0):
        perm = torch.sort(sort.digit_of(keys, shift), stable=True).indices
        return keys[perm], values[perm]

    assert torch.equal(library_counts().int(), counts)
    lk, lv = library_pass()
    ko, vo = R.digit_pass(keys, values, bases, 0)
    assert torch.equal(lk, ko) and torch.equal(lv, vo)
    del lk, lv, ko, vo
    times = {
        "digit_counts": {
            "ms": cold(lambda: R.digit_counts(keys)),
            "plain_ms": cold(lambda: R.digit_counts_plain(keys)),
            "library_ms": cold(library_counts),
            "library": "torch.bincount of the four digits (index arithmetic included)",
            "min_bytes": n * 8 + 4 * 1024,
            "one_digit_per_block_form": {
                "ms": cold(lambda: R.digit_histogram(keys, 0)),
                "plain_ms": cold(lambda: R.digit_histogram_plain(keys, 0)),
                "min_bytes": n * 8 + nblocks * 1024},
        },
        "exclusive_scan": {
            "ms": cold(lambda: K5(counts)),
            "plain_ms": cold(lambda: scan.exclusive_scan_plain(counts)),
            "library_ms": cold(lambda: torch.cumsum(counts, 0, dtype=torch.int32)),
            "library": "torch.cumsum(counts, 0, dtype=torch.int32) (inclusive; no shift)",
            "min_bytes": 2 * 4 * counts.shape[0],
            "at_262144": {"ms": cold(lambda: K5(hist_t)),
                          "library_ms": cold(lambda: torch.cumsum(hist_t, 0, dtype=torch.int32)),
                          "min_bytes": 2 * 4 * hist_t.shape[0]},
        },
        "digit_pass": {
            "ms": cold(lambda: R.digit_pass(keys, values, bases, 0)),
            "ms_shift_24": cold(lambda: R.digit_pass(keys, values, bases, 24)),
            "plain_ms": cold(lambda: R.digit_pass_plain(keys, values, bases, 0), iters=3),
            "library_ms": cold(library_pass),
            "library": "torch.sort(digit_of(keys, 0), stable=True) and the two gathers",
            "min_bytes": n * 24 + 4 * 1024,
            "with_observables_ms": cold(lambda: R.digit_pass(keys, values, bases, 0,
                                                             observe=True)),
            "rank_only_form": {
                "ms": cold(lambda: R.digit_rank(keys, scanned, 0)),
                "plain_ms": cold(lambda: R.digit_rank_plain(keys, scanned, 0), iters=3),
                "min_bytes": n * 12 + nblocks * 1024},
        },
    }
    for t in (times["digit_counts"], times["exclusive_scan"], times["digit_pass"]):
        # A few integer operations a key against 8 bytes and more: bytes bound.
        t["bound_ms"] = t["min_bytes"] / PEAK_BYTES_PER_S * 1e3
        t["bound_by"] = "bytes"
    pass_debug_ms = cold(lambda: R.cuda_pass_debug(keys, values, 0))

    def in_turns(fns, iters=5):
        out = {k: [] for k in fns}
        for k in list(fns) + list(fns)[::-1]:
            out[k].append(cold(fns[k], iters=iters))
        return out

    sort_1m = in_turns({"cuda": lambda: sort.sort_key_val(keys, values, impl="cuda"),
                        "torch": lambda: sort.sort_key_val(keys, values, impl="torch")})
    pass_1m = in_turns({"digit_pass": lambda: R.digit_pass(keys, values, bases, 0),
                        "torch.sort_of_the_digit_and_gathers": library_pass})
    emit("sort_kernels_vs_plain",
         tolerance="bit-identical for int32/int64 (every output of every kernel); float32 "
                   "scan within 1e-5 of the running sum of magnitudes (tree and look-back "
                   "summation order)",
         cases=cases, scan_cases=scan_cases, max_abs_err=err,
         times_at_1m_keys={"keys": n, "blocks": nblocks, "tiles": -(-n // R.TILE),
                           "kernels": times, "cuda_pass_debug_ms": pass_debug_ms,
                           "sum_of_parts_ms": times["digit_counts"]["ms"]
                           + times["exclusive_scan"]["ms"] + 4 * times["digit_pass"]["ms"],
                           "four_pass_sort_ms_in_turns": sort_1m,
                           "one_pass_ms_in_turns": pass_1m},
         timing="CUDA events, median of 5 after a warm-up, 256 MB written before each sample, "
                "the device held while the host enqueues",
         nvidia_smi=smi)
    del dst, hist_t, scanned

    # ---- sort_path ---------------------------------------------------------
    # The slice's main path, counts set to 0 just before and read just after.
    counters = (R.digit_counts, R.digit_pass, R.digit_histogram, R.digit_rank)

    def launches():
        out = {f.__name__: f.launches for f in counters}
        out["exclusive_scan"] = K5.launches
        out["exclusive_scan_device_launches"] = K5.device_launches
        return out

    for f in (*counters, K5):
        f.launches = 0
    K5.device_launches = 0
    bvh_cuda = rt.build_bvh(scene_260k, sort_impl="cuda", builder="karras")
    torch.cuda.synchronize()
    after_build = launches()
    assert after_build == {"digit_counts": 1, "digit_pass": 4, "digit_histogram": 0,
                           "digit_rank": 0, "exclusive_scan": 1,
                           "exclusive_scan_device_launches": 1}, \
        f"one 'cuda' sort launched {after_build}"
    cam = rt.make_camera(eye=(110.0, 90.0, 140.0), target=(0.0, 0.0, 0.0), width=W, height=H)
    frame = rt.render_frame(scene_260k, bvh_cuda, cam, tex, bg, shadows=True)
    image_cuda = rt.frame_to_image(frame)
    t0 = time.perf_counter()
    bvh_validated = rt.build_bvh(scene_260k, builder="karras", validate=True)
    torch.cuda.synchronize()
    validate_s = time.perf_counter() - t0
    path_launches = launches()
    # validate=True drives every pass of the "cuda" engine on its own: the
    # count, its scan and one pass for each of the four digits.
    assert path_launches == {"digit_counts": 5, "digit_pass": 8, "digit_histogram": 0,
                             "digit_rank": 0, "exclusive_scan": 5,
                             "exclusive_scan_device_launches": 5}, path_launches

    assert image_cuda.tobytes() == main_image.tobytes(), \
        "the frame from the sort_impl='cuda' tree differs from the main path's frame"
    bvh_torch = rt.build_bvh(scene_260k, sort_impl="torch", builder="karras")
    arrays = bvh_bits_equal(parity, bvh_cuda, bvh_torch, "260,642 triangles, cuda vs torch")
    bvh_bits_equal(parity, bvh_validated,
                   rt.build_bvh(scene_260k, builder="karras", diagnostics=True),
                   "validate=True vs diagnostics=True")
    bvh_bits_equal(parity, rt.build_bvh(scene_260k, sort_impl="radix", builder="karras"),
                   bvh_torch, "260,642 triangles, radix vs torch")
    bvh_bits_equal(parity, rt.build_bvh(scene_1m, sort_impl="cuda", builder="karras"),
                   rt.build_bvh(scene_1m, sort_impl="torch", builder="karras"),
                   "1,048,352 triangles, cuda vs torch")

    # A deliberately corrupted pass must not get past the validators.
    ko, vo, hist_t, scanned = R.cuda_pass_debug(scene_260k.morton, scene_260k.tri_index, 0)
    validate.validate_sort_pass(scene_260k.morton, scene_260k.tri_index, ko, vo, hist_t,
                                scanned, 0, BLOCK)
    bad = ko.clone()
    bad[[3, 200000]] = ko[[200000, 3]]
    assert int(bad[3]) != int(ko[3])
    try:
        validate.validate_sort_pass(scene_260k.morton, scene_260k.tri_index, bad, vo, hist_t,
                                    scanned, 0, BLOCK)
    except AssertionError as e:
        corrupted = str(e)
    else:
        raise AssertionError("validate_sort_pass accepted a pass with two keys swapped")

    # 2^22 random keys: the stable permutation is unique.
    big = kind_keys("random", 1 << 22)
    big_v = torch.arange(1 << 22, dtype=torch.int32, device="cuda")
    gk, gv = R.radix_sort_key_val_cuda(big, big_v)
    wk, perm = torch.sort(big, stable=True)
    assert torch.equal(gk, wk) and torch.equal(gv, big_v[perm])
    big_bases = K5(R.digit_counts(big))
    sort_4m = in_turns({"cuda": lambda: sort.sort_key_val(big, big_v, impl="cuda"),
                        "torch": lambda: sort.sort_key_val(big, big_v, impl="torch")})
    pass_4m = in_turns({
        "digit_pass": lambda: R.digit_pass(big, big_v, big_bases, 0),
        "torch.sort_of_the_digit_and_gathers": lambda: (
            lambda p: (big[p], big_v[p]))(torch.sort(sort.digit_of(big, 0), stable=True).indices)})
    del big, big_v, gk, gv, wk, perm, big_bases

    builds = {}
    for label, scene, iters in (("260642", scene_260k, 5), ("1048352", scene_1m, 3)):
        builds[label] = {}
        for builder in ("karras", "sah_free"):
            builds[label][builder] = {"torch": [], "cuda": []}
            for which in ("torch", "cuda", "cuda", "torch"):
                builds[label][builder][which].append(timer.median_ms(
                    lambda: rt.build_bvh(scene, sort_impl=which, builder=builder),
                    iters=iters))
        builds[label]["sort_only"] = {
            which: timer.median_ms(
                lambda: sort.sort_key_val(scene.morton, scene.tri_index, impl=which))
            for which in ("torch", "cuda", "radix")}
    emit("sort_path", triangles=[260642, 1048352], bvh_arrays_bit_identical=arrays,
         launches_of_one_cuda_sort=after_build, launches_on_the_path=path_launches,
         frame_from_cuda_tree_equals_main_path_frame=True,
         validate_true_seconds_260k=validate_s, corrupted_pass_raised=corrupted,
         sort_4m_keys_identical_to_stable_torch_sort=True,
         sort_4m_keys_ms_in_turns=sort_4m, pass_4m_keys_ms_in_turns=pass_4m,
         build_ms_in_turns=builds,
         timing="sorts and passes: CUDA events, median of 5, cold L2, the device held while "
                "the host enqueues; builds and sort_only: CUDA events at the host's pace, "
                "median of 5 (3 at 1,048,352) after a warm-up",
         nvidia_smi=smi)

    sources = {
        "digit_counts": ("unitysimpleraytracing_tpu/ops/sort_pallas.py:60",
                         "ops/sort_pallas.py::_hist_kernel",
                         f"{n} int64 keys -> (1024,) int32, the four passes' digit counts; "
                         "digit_histogram, its one-digit form: (256 * nblocks,) int32"),
        "digit_pass": ("unitysimpleraytracing_tpu/ops/sort_pallas.py:68",
                       "ops/sort_pallas.py::_rank_kernel",
                       f"{n} int64 keys + int32 values, (1024,) int32 bases -> keys and "
                       "values moved; digit_rank, its rank-only form: (n,) int32"),
        "exclusive_scan": ("unitysimpleraytracing_tpu/ops/scan_pallas.py:36",
                           "ops/scan_pallas.py::_kernel",
                           "(1024,) int32 digit counts, 1 device launch a call"),
    }
    entries = []
    for name in ("digit_counts", "digit_pass", "exclusive_scan"):
        replaces, function, shape = sources[name]
        t = times[name]
        source = "unitysimpleraytracing_tpu_torch/csrc/" + (
            "scan.cu" if name == "exclusive_scan" else "radix_sort.cu")
        max_err = max(err[name], err.get({"digit_counts": "digit_histogram",
                                          "digit_pass": "digit_rank"}.get(name, name), 0.0))
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "replaces_function": function, "launches": path_launches[name],
            "max_abs_err": max_err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "shape": shape,
        })
    return entries


def traversal_entry(on_tree, name, replaces, function, launches, slots, n_rays):
    """The ``kernels`` line's entry of a traversal kernel: its times on the
    main path's rays over the default tree (``ms``), the Karras tree's beside
    them (``ms_karras_tree``), the bound of the default tree's primary rays."""
    p, s = on_tree["default"][name]["primary"], on_tree["default"][name]["shadow"]
    karras = on_tree["karras"][name]
    records = on_tree["default"]["records"][name]
    return {
        "name": name, "route": "cuda",
        "source": f"unitysimpleraytracing_tpu_torch/csrc/{name}.cu",
        "replaces": f"unitysimpleraytracing_tpu/{replaces}", "replaces_function": function,
        "launches": launches,
        "max_abs_err": max(p["compare"]["max_abs_err"], s["compare"]["max_abs_err"]),
        "ms": p["ms_cold_l2"], "ms_primary": p["ms_cold_l2"], "ms_shadow": s["ms_cold_l2"],
        "ms_karras_tree": karras["primary"]["ms_cold_l2"],
        "ms_karras_tree_shadow": karras["shadow"]["ms_cold_l2"],
        "plain_ms": p["plain_ms"], "records_per_ray": p["records_per_ray"],
        "warp_lane_efficiency": p["warp_lane_efficiency"], "loaded_bytes": p["loaded_bytes"],
        "bound_ms": p["bound_ms"], "bound_by": p["bound_by"], "bound_ms_shadow": s["bound_ms"],
        "library_ms": None,
        "shape": f"{n_rays} primary rays over the default tree's ({records}, {slots}) "
                 "float32 table",
    }


def run_compressed_records(rt, timer, parity, scene, tree, rays, table, n_rays):
    """K1c, the compressed-record entry point of ``csrc/trace_bvh4.cu``, at
    the main path's shapes: the path a caller takes,
    ``trace_rays(scene, bvh, o, d, tables=compress_tables4(prepare_tables4(...)))``,
    for the frame's primary and shadow rays, driven with the count set to 0
    just before and read just after; then the kernel against its plain
    version (`traversal_on_tree`, bit for bit, records popped included) and
    in turns with K1 on the same primary rays.  Returns (launches, fields)."""
    from unitysimpleraytracing_tpu_torch.ops import dispatch, trace_bvh4

    K1 = trace_bvh4.traverse_bvh4
    comp = trace_bvh4.compress_tables4(table)
    (po, pd, _), (so, sd, thr) = rays["primary"], rays["shadow"]
    K1.compressed_launches = 0
    primary = dispatch.trace_rays(scene, tree, po, pd, tables=comp)
    shadow = dispatch.trace_rays(scene, tree, so, sd, tables=comp, anyhit_thresh=thr)
    torch.cuda.synchronize()
    launches = K1.compressed_launches
    assert launches == 2, f"the compressed path launched K1c {launches} times, not 2"
    full = dispatch.trace_rays(scene, tree, po, pd, tables=table)
    full_shadow = dispatch.trace_rays(scene, tree, so, sd, tables=table, anyhit_thresh=thr)
    on_tree = traversal_on_tree(timer, parity, trace_bvh4, comp, rays, n_rays)
    turns = [[name, timer.median_ms(fn, iters=7, cold=True, queued=True)]
             for name, fn in (("k1", lambda: K1(table, po, pd)), ("k1c", lambda: K1(comp, po, pd)),
                              ("k1c", lambda: K1(comp, po, pd)), ("k1", lambda: K1(table, po, pd)))]
    return launches, {
        "records": int(comp.shape[0]), "record_bytes": RECORD_BYTES_C,
        "table_mb": comp.numel() * 4 / 2**20, "table_mb_uncompressed": table.numel() * 4 / 2**20,
        "launches_on_the_path": launches, "kernel": on_tree,
        "primary_rays_where_t_or_tri_differ_from_k1": int(
            ((primary.t != full.t) | (primary.tri != full.tri)).sum()),
        "shadow_rays_where_occlusion_differs_from_k1": int(
            ((shadow.hit & (shadow.t < thr)) != (full_shadow.hit & (full_shadow.t < thr))).sum()),
        "primary_ms_in_turns_cold_l2": turns,
        "k1c_over_k1": (turns[1][1] + turns[2][1]) / (turns[0][1] + turns[3][1]),
    }


def compressed_entry(k1c, launches, n_rays):
    """The ``kernels`` line's entry of K1c (primary rays, default tree)."""
    p, s = k1c["kernel"]["primary"], k1c["kernel"]["shadow"]
    return {
        "name": "trace_bvh4_compressed", "route": "cuda",
        "source": "unitysimpleraytracing_tpu_torch/csrc/trace_bvh4.cu",
        "replaces": "unitysimpleraytracing_tpu/ops/trace_pallas4.py:366",
        "replaces_function": "ops/trace_pallas4.py::_make_kernel4(compress=True)",
        "launches": launches,
        "max_abs_err": max(p["compare"]["max_abs_err"], s["compare"]["max_abs_err"]),
        "ms": p["ms_cold_l2"], "ms_shadow": s["ms_cold_l2"], "plain_ms": p["plain_ms"],
        "records_per_ray": p["records_per_ray"], "loaded_bytes": p["loaded_bytes"],
        "bound_ms": p["bound_ms"], "bound_by": p["bound_by"], "bound_ms_shadow": s["bound_ms"],
        "library_ms": None,
        "shape": f"{n_rays} primary rays over the default tree's ({k1c['records']}, 52) "
                 "float32 compressed table",
    }


def kernel_cases_65k(rt, timer, module, table, soup_table, s65):
    """One traversal kernel (``module`` = ops/trace_bvh4 or ops/trace_bvh2)
    against its plain version at the 65,522-triangle terrain / 512x512 and
    65,536-triangle soup shapes: nearest hit, ``t_init`` above and below,
    any-hit shadow rays, incoherent rays.  Returns (cases, hits of case a)."""
    from unitysimpleraytracing_tpu_torch.ops import dispatch
    from unitysimpleraytracing_tpu_torch.pipeline import render
    from unitysimpleraytracing_tpu_torch.utils import parity

    kernel, plain = engine_of(module)
    o, d = s65.o, s65.d
    cases = []
    st, first, _, _ = compare_kernel_with_plain(
        "a: terrain 65,522 tris, 512x512 camera rays, tile-major",
        module, parity, table, o, d)
    cases.append(st)

    # (c) t_init just above / just below the first pass (additive margin:
    # t may be negative, there is no t>0 test).
    t_first = first.t
    hit = first.hit
    eps = 0.01 * torch.clamp(t_first.abs(), min=1.0)
    big = torch.full_like(t_first, float(MAX_FLOAT))
    above = torch.where(hit, t_first + eps, big)
    below = torch.where(hit, t_first - eps, big)
    st, got_above, _, _ = compare_kernel_with_plain(
        "c1: case a with t_init just above the first pass",
        module, parity, table, o, d, t_init=above)
    assert torch.equal(got_above.t[hit], t_first[hit]), "t_init above lost a hit"
    cases.append(st)
    st, got_below, _, _ = compare_kernel_with_plain(
        "c2: case a with t_init just below the first pass",
        module, parity, table, o, d, t_init=below)
    assert not bool((got_below.t < below).any()), "t_init below was undercut"
    cases.append(st)

    # (d) the shadow rays of case a, any-hit mode: boolean identical.
    first_rm = rt.HitRecord(
        t=dispatch._row_major(first.t, 512, 512, 32),
        tri=dispatch._row_major(first.tri, 512, 512, 32),
        u=dispatch._row_major(first.u, 512, 512, 32),
        v=dispatch._row_major(first.v, 512, 512, 32),
    )
    so, sd, bound = render.shadow_rays(s65.scene, s65.bvh, first_rm, s65.cam)
    bo, bd, thr, limit = dispatch.occlusion_rays(
        s65.scene, dispatch._tile_major(so, 512, 512, 32),
        dispatch._tile_major(sd, 512, 512, 32), origin_bound=bound)
    bo, bd = bo.contiguous(), bd.contiguous()
    got = kernel(table, bo, bd, anyhit_thresh=thr)
    want = plain(table, bo, bd, anyhit_thresh=thr)
    occ_g = got.hit & (got.t < limit)
    occ_w = want.hit & (want.t < limit)
    assert torch.equal(occ_g, occ_w), "any-hit occlusion booleans differ"
    cases.append({
        "case": "d: shadow rays of case a, any-hit", "rays": int(occ_g.numel()),
        "occluded": int(occ_g.sum()), "boolean_mismatches": 0,
        "records_bit_identical": bool(
            torch.equal(got.t, want.t) and torch.equal(got.tri, want.tri)),
    })

    # (b) incoherent rays through a triangle soup.
    st, _, _, _ = compare_kernel_with_plain(
        "b: soup 65,536 tris, 65,536 random rays", module, parity,
        soup_table, s65.ro, s65.rd)
    _, soup_steps = kernel(soup_table, s65.ro, s65.rd, count_steps=True)
    st["kernel_ms_cold_l2"] = timer.median_ms(
        lambda: kernel(soup_table, s65.ro, s65.rd), cold=True)
    st["records_per_ray"] = float(soup_steps.float().mean())
    st["max_pops"] = int(soup_steps.max())
    cases.append(st)
    return cases, first


def run_dynamic_path(rt, timer, scene, bvh, cam, tex, bg, W, H, main_image):
    """The dynamic-scene paths at full width, on the main path's scene:
    ``render_frames`` over a group of orbit cameras and
    ``make_animated_renderer`` over a deforming mesh, each through the BVH4
    kernel (K1) and the binary-record kernel (K2).  The paths are driven
    first, with the launch counts set to 0 just before and read just after;
    what they gave is then held against per-frame and unfused references and
    timed.  Returns (launch counts of the drive, the phase's fields)."""
    from unitysimpleraytracing_tpu_torch import cli
    from unitysimpleraytracing_tpu_torch.ops import (
        dispatch, lbvh, refit_bvh4, trace_bvh2, trace_bvh4,
    )
    from unitysimpleraytracing_tpu_torch.utils import parity

    K1, K2 = trace_bvh4.traverse_bvh4, trace_bvh2.traverse_bvh2
    refit_k, records_k = refit_bvh4.refit_nodes, refit_bvh4.write_records
    # The group the CLI's --orbit-batch makes at this resolution.
    F = max(1, (1 << 22) // (W * H))
    assert F == 2
    eyes = cli.orbit_eyes((110.0, 90.0, 140.0), (0.0, 0.0, 0.0), 16)[:F]
    cams = [rt.make_camera(eye=e, target=(0.0, 0.0, 0.0), width=W, height=H) for e in eyes]
    stack = rt.stack_cameras(cams)
    # The deformation of the animated path: a travelling wave in height.
    tris = scene.triangles
    base = torch.stack([tris.a, tris.b, tris.c], dim=1)  # (capacity, 3, 3)
    phases = (0.3, 1.1, 1.9, 2.7)

    def deformed(phase):
        pos = base.clone()
        pos[..., 1] += 0.4 * torch.sin(base[..., 0] * 0.5 + phase)
        return pos

    positions = [deformed(ph) for ph in phases]
    # Tables and plans are made before the count starts, as a renderer that
    # has shown its first frame has them.
    trace_bvh4.prepare_tables4(scene, bvh)
    trace_bvh2.prepare_tables(scene, bvh)
    anim = {impl: rt.make_animated_renderer(scene, bvh, cam, impl=impl)
            for impl in ("cuda4", "cuda2")}

    # -- the drive: counts 0 just before, read just after -------------------
    K1.launches = K2.launches = refit_k.launches = records_k.launches = 0
    batch = {"auto": rt.render_frames(scene, bvh, stack, tex, bg, shadows=True)}
    after_batch4 = (K1.launches, K2.launches)
    batch["cuda2"] = rt.render_frames(scene, bvh, stack, tex, bg, impl="cuda2", shadows=True)
    after_batch2 = (K1.launches, K2.launches)
    anim_hits = {impl: [anim[impl](pos) for pos in positions] for impl in ("cuda4", "cuda2")}
    torch.cuda.synchronize()
    launches = {"trace_bvh4": K1.launches, "trace_bvh2": K2.launches,
                "refit": refit_k.launches, "records": records_k.launches}
    assert after_batch4 == (2, 0), f"a batch of {F} frames launched {after_batch4}, not 2 of K1"
    assert after_batch2 == (2, 2), f"the cuda2 batch launched {after_batch2}"
    assert launches == {"trace_bvh4": 2 + len(phases), "trace_bvh2": 2 + len(phases),
                        "refit": 2 * len(phases), "records": len(phases)}, launches

    # -- batched frames against per-frame frames -----------------------------
    single = {impl: [rt.render_frame(scene, bvh, c, tex, bg, impl=impl, shadows=True)
                     for c in cams] for impl in ("auto", "cuda2")}
    for impl in ("auto", "cuda2"):
        assert tuple(batch[impl].shape) == (F, H, W, 4)
        for i in range(F):
            assert torch.equal(batch[impl][i], single[impl][i]), \
                f"render_frames(impl={impl!r}) frame {i} differs from render_frame"
    assert rt.frame_to_image(batch["auto"][0]).tobytes() == main_image.tobytes(), \
        "frame 0 of the orbit is not the main path's frame"
    frac_2_vs_4 = [parity.compare_images(
        parity.frame_to_uint8(rt.frame_to_image(batch["cuda2"][i])),
        parity.frame_to_uint8(rt.frame_to_image(batch["auto"][i])),
        f"cuda2 vs cuda4, frame {i}") for i in range(F)]
    values_differing = [int((batch["cuda2"][i] != batch["auto"][i]).sum()) for i in range(F)]

    def batched(impl):
        return lambda: rt.render_frames(scene, bvh, stack, tex, bg, impl=impl, shadows=True)

    def per_frame(impl):
        return lambda: [rt.render_frame(scene, bvh, c, tex, bg, impl=impl, shadows=True)
                        for c in cams]

    ms_per_frame = {}
    for impl in ("auto", "cuda2"):
        ms_per_frame[impl] = [
            [name, timer.median_ms(fn(impl), iters=3) / F]
            for name, fn in (("batched", batched), ("per_frame", per_frame),
                             ("per_frame", per_frame), ("batched", batched))]
    del batch, single

    # -- animated frames against the unfused sequence -------------------------
    from unitysimpleraytracing_tpu_torch.pipeline.build import deform_scene, refit_bvh

    animated = {}
    for impl in ("cuda4", "cuda2"):
        equal = True
        for pos, got in zip(positions, anim_hits[impl]):
            s2 = deform_scene(scene, pos)
            b2 = refit_bvh(s2, bvh)
            ref = rt.render_hits(s2, b2, cam, impl=impl)
            assert torch.equal(got.hit, ref.hit), f"animated {impl}: hit masks differ"
            assert torch.equal(got.tri[ref.hit], ref.tri[ref.hit]), f"animated {impl}: tri"
            assert torch.equal(got.t, ref.t), f"animated {impl}: t differs"
            equal = equal and torch.equal(got.u, ref.u) and torch.equal(got.v, ref.v)
        static = rt.render_hits(scene, bvh, cam, impl=impl)
        moved = [int((h.tri != static.tri).sum()) for h in anim_hits[impl]]
        assert min(moved) > 0, "the deformation changed no pixel"
        pos = positions[0]
        s2 = deform_scene(scene, pos)
        b2 = refit_bvh(s2, bvh)
        # The two kernels of the frame against their plain versions, word
        # for word (signed zeros included).
        plain_boxes = lbvh.refit(bvh.range_first, bvh.range_last, bvh.sorted_tri,
                                 s2.aabb_min, s2.aabb_max, bvh.count)
        for got, want in zip((b2.node_aabb_min, b2.node_aabb_max), plain_boxes):
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
                "the refit kernel differs from lbvh.refit"
        if impl == "cuda4":
            mask, new_id, cap4 = trace_bvh4._node_mask_cached(bvh)
            plan = trace_bvh4._pack_plan4(bvh, mask, new_id, max(cap4, 1))
            assert torch.equal(trace_bvh4._apply_plan4(s2, b2, *plan).view(torch.int32),
                               refit_bvh4.write_records_plain(s2, b2, *plan).view(torch.int32)), \
                "the record kernel differs from its plain version"

            def update():
                return trace_bvh4._apply_plan4(s2, b2, *plan)
        else:
            def update():
                return trace_bvh2.pack_tables(s2, b2)
        tables = update()
        animated[impl] = {
            "frames": len(phases), "bit_identical_to_unfused": equal,
            "refit_and_records_bit_identical_to_plain": True,
            "pixels_whose_triangle_moved": moved, "kernel_launches_per_frame": 1,
            "hit_fraction": float(anim_hits[impl][0].hit.float().mean()),
            "stage_ms": {
                "deform": timer.median_ms(lambda: deform_scene(scene, pos)),
                "refit": timer.median_ms(lambda: refit_bvh(s2, bvh)),
                "table_update" if impl == "cuda4" else "table_repack":
                    timer.median_ms(update),
                "trace": timer.median_ms(
                    lambda: dispatch.camera_trace(s2, b2, cam, impl=impl, tables=tables)),
            },
        }
        del tables, s2, b2
    turns = [[impl, timer.median_ms(lambda: anim[impl](positions[1]), iters=5)]
             for impl in ("cuda4", "cuda2", "cuda2", "cuda4")]
    return launches, {
        "frames_per_batch": F, "batched_equals_per_frame_byte_for_byte": True,
        "launches_on_the_path": launches,
        "launches_of_one_batch": {"auto": {"trace_bvh4": 2}, "cuda2": {"trace_bvh2": 2}},
        "cuda2_vs_cuda4_fraction_off_by_more_than_2_of_255": frac_2_vs_4,
        "cuda2_vs_cuda4_float_values_differing": values_differing,
        "ms_per_frame_in_turns": ms_per_frame,
        "animated": animated, "animated_frame_ms_in_turns": turns,
        "timing": "CUDA events, median of 3 (batches) or 5 after a warm-up",
    }


def run_chunked_path(rt, timer, smi, tex, bg, W, H, out_dir):
    """Large scenes: the 4,193,408-triangle terrain, above the single-tree
    limit of 2,097,151, through ``build_bvh_chunked`` (26 chunks of 163,840,
    "sah") and ``render_frame_chunked`` at 1920x1056 with shadows, driven
    with K1's launch count set to 0 just before the frame and read just
    after; K1 against its plain version through ``trace_chunked`` at the
    frame's own shapes (all 2,027,520 tile-major primary rays with the fold's
    ``t_init``, then the shadow rays' any-hit pass), bit for bit, and on
    4,096 of the frame's rays against ``brute_force_trace`` under the parity
    contract.  At 1,048,352 triangles: one tree against chunks (the CLI's
    switch point), binary chunk records (K2, held to its plain version at
    the frame's shapes the same way), and a save → load → trace round trip
    of the chunked checkpoint.  Emits ``chunked_path``."""
    from unitysimpleraytracing_tpu_torch.core.camera import generate_rays
    from unitysimpleraytracing_tpu_torch.io import checkpoint
    from unitysimpleraytracing_tpu_torch.io.png import write_png
    from unitysimpleraytracing_tpu_torch.ops import dispatch, trace, trace_bvh2, trace_bvh4
    from unitysimpleraytracing_tpu_torch.pipeline import chunked
    from unitysimpleraytracing_tpu_torch.utils import parity

    K1, K2 = trace_bvh4.traverse_bvh4, trace_bvh2.traverse_bvh2
    t_phase = time.perf_counter()

    def host_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def pick_rays(cam, n=4096):
        o, d = generate_rays(cam)
        pick = torch.linspace(0, cam.width * cam.height - 1, n, device="cuda").long()
        return o[pick].contiguous(), d[pick].contiguous()

    def bit_identical(got, want, what):
        for f in ("t", "tri", "u", "v"):
            g, w = getattr(got, f), getattr(want, f)
            if g.dtype == torch.float32:
                g, w = g.view(torch.int32), w.view(torch.int32)
            assert torch.equal(g, w), f"{what}: {f} differs"
        return True

    def frame_kernel_vs_plain(cb, cam_, kernel, plain):
        """The kernel against its plain version on the inputs the chunked
        frame gives it: every tile-major primary ray (not routed, ``t_init``
        from the fold), then the shadow rays' backward any-hit pass (routed),
        made from the kernel's hits as `render_rgba_chunked` makes them."""
        t0 = time.perf_counter()
        o, d = generate_rays(cam_)
        h, w = cam_.height, cam_.width
        ot, dt = dispatch._tile_major(o, h, w, 32), dispatch._tile_major(d, h, w, 32)
        del o, d
        got = rt.trace_chunked(cb, ot, dt, impl=kernel, route=False)
        bit_identical(got, rt.trace_chunked(cb, ot, dt, impl=plain, route=False),
                      f"trace_chunked {kernel} vs {plain}, primary rays")
        so, sd, bound = chunked._shadow_rays_chunked(cb, got, ot, dt)
        bo, bd, thresh, limit = chunked.occlusion_rays_chunked(cb, so, sd, origin_bound=bound)
        del so, sd
        shadow = rt.trace_chunked(cb, bo, bd, impl=kernel, anyhit_thresh=thresh)
        bit_identical(shadow, rt.trace_chunked(cb, bo, bd, impl=plain, anyhit_thresh=thresh),
                      f"trace_chunked {kernel} vs {plain}, shadow rays")
        torch.cuda.synchronize()
        return {f"{kernel}_bit_identical_to_{plain}": True, "rays_per_pass": int(ot.shape[0]),
                "primary_hits": int(got.hit.sum()), "occluded": int((shadow.hit & (shadow.t < limit) & got.hit).sum()),
                "seconds": time.perf_counter() - t0}

    # -- 4,193,408 triangles in 26 chunks --------------------------------------
    mesh = rt.terrain_mesh(res=1449, size=600.0, amplitude=60.0, seed=3)
    assert mesh.num_triangles == 4193408, mesh.num_triangles
    scene, ingest_ms = host_ms(lambda: rt.build_scene(mesh))
    del mesh
    cbvh, build_ms = host_ms(lambda: rt.build_bvh_chunked(scene))
    S = cbvh.num_chunks
    assert S == 26 and cbvh.capacity <= 163840, (S, cbvh.capacity)
    assert scene.capacity > dispatch.MAX_CAPACITY
    cam = rt.make_camera(eye=(420.0, 340.0, 520.0), target=(0.0, 0.0, 0.0), width=W, height=H)
    K1.launches = 0
    frame = rt.render_frame_chunked(scene, cbvh, cam, tex, bg, shadows=True)
    torch.cuda.synchronize()
    frame_launches = K1.launches
    assert frame_launches == 2 * S, f"the chunked frame launched K1 {frame_launches} times"
    image = rt.frame_to_image(frame)
    assert image.shape == (H, W, 4) and np.isfinite(image).all()
    png = os.path.join(out_dir, "chip_smoke_4m_chunked_1920x1056.png")
    write_png(png, image)
    hits = rt.render_hits_chunked(scene, cbvh, cam)
    hit_fraction = float(hits.hit.float().mean())
    assert 0.05 < hit_fraction < 0.95, hit_fraction
    # Pixels that miss where their four neighbours hit: Möller–Trumbore is not
    # watertight (a ray through a shared edge can fail both triangles' u, v
    # tests), as in the reference.  Each such ray must miss every triangle.
    hm = hits.hit.reshape(H, W)
    crack = torch.zeros_like(hm)
    crack[1:-1, 1:-1] = (~hm[1:-1, 1:-1] & hm[:-2, 1:-1] & hm[2:, 1:-1]
                         & hm[1:-1, :-2] & hm[1:-1, 2:])
    o_all, d_all = generate_rays(cam)
    idx = crack.reshape(-1).nonzero()[:, 0]
    cracks = {"pixels": int(idx.numel())}
    if idx.numel():
        brute_cracks = trace.brute_force_trace(
            scene, o_all[idx].contiguous(), d_all[idx].contiguous(), chunk=16384)
        cracks["missing_every_triangle"] = int((~brute_cracks.hit).sum())
        assert cracks["missing_every_triangle"] == cracks["pixels"], cracks
    del o_all, d_all
    frame_ms = timer.median_ms(
        lambda: rt.render_frame_chunked(scene, cbvh, cam, tex, bg, shadows=True), iters=3)
    oo, dd = pick_rays(cam)
    got = rt.trace_chunked(cbvh, oo, dd, impl="cuda4")
    want = rt.trace_chunked(cbvh, oo, dd, impl="plain4")
    torch.cuda.synchronize()
    kernel_vs_plain = bit_identical(got, want, "trace_chunked cuda4 vs plain4")
    frame_vs_plain = frame_kernel_vs_plain(cbvh, cam, "cuda4", "plain4")
    brute = trace.brute_force_trace(scene, oo, dd, chunk=16384)
    vs_brute = parity.assert_hit_parity(np_hits(got), np_hits(brute), uv_atol=1e-5)
    table_mb = cbvh.tables.numel() * 4 / 2**20
    cbvh_capacity = cbvh.capacity
    del frame, hits, cbvh, scene, brute
    torch.cuda.empty_cache()

    # -- 1,048,352 triangles: one tree against chunks ---------------------------
    mesh = rt.terrain_mesh(res=725, size=300.0, amplitude=30.0, seed=0)
    assert mesh.num_triangles == 1048352
    scene = rt.build_scene(mesh)
    cam1 = rt.make_camera(eye=(210.0, 170.0, 260.0), target=(0.0, 0.0, 0.0), width=W, height=H)
    tree, tree_build_ms = host_ms(lambda: rt.build_bvh(scene))
    chunks, chunks_build_ms = host_ms(lambda: rt.build_bvh_chunked(scene))
    S1 = chunks.num_chunks
    one = rt.render_frame(scene, tree, cam1, tex, bg, shadows=True)
    K1.launches = 0
    many = rt.render_frame_chunked(scene, chunks, cam1, tex, bg, shadows=True)
    torch.cuda.synchronize()
    assert K1.launches == 2 * S1, K1.launches
    frac_chunks_vs_tree = parity.compare_images(
        parity.frame_to_uint8(rt.frame_to_image(many)),
        parity.frame_to_uint8(rt.frame_to_image(one)), "chunks vs one tree, 1M")
    fns = {"one_tree": lambda: rt.render_frame(scene, tree, cam1, tex, bg, shadows=True),
           "chunks": lambda: rt.render_frame_chunked(scene, chunks, cam1, tex, bg,
                                                     shadows=True)}
    turns = [[k, timer.median_ms(fns[k], iters=3)]
             for k in ("one_tree", "chunks", "chunks", "one_tree")]

    # Binary chunk records (K2) at this depth, against the BVH4 chunks' frame.
    chunks2, chunks2_build_ms = host_ms(
        lambda: rt.build_bvh_chunked(scene, record_format="bvh2"))
    K2.launches = 0
    many2 = rt.render_frame_chunked(scene, chunks2, cam1, tex, bg, shadows=True)
    torch.cuda.synchronize()
    assert K2.launches == 2 * S1, K2.launches
    frac_bvh2 = parity.compare_images(
        parity.frame_to_uint8(rt.frame_to_image(many2)),
        parity.frame_to_uint8(rt.frame_to_image(many)), "bvh2 chunks vs bvh4 chunks, 1M")
    oo, dd = pick_rays(cam1)
    bvh2_vs_plain = bit_identical(rt.trace_chunked(chunks2, oo, dd, impl="cuda2"),
                                  rt.trace_chunked(chunks2, oo, dd, impl="plain2"),
                                  "trace_chunked cuda2 vs plain2")
    bvh2_frame_vs_plain = frame_kernel_vs_plain(chunks2, cam1, "cuda2", "plain2")
    bvh2_frame_ms = timer.median_ms(
        lambda: rt.render_frame_chunked(scene, chunks2, cam1, tex, bg, shadows=True), iters=3)
    del chunks2, many2, one

    # Save → load → trace round trip of the chunked checkpoint.
    path = os.path.join(out_dir, "chunked_1m.npz")
    _, save_ms = host_ms(lambda: checkpoint.save_chunked_checkpoint(path, chunks))
    file_mb = os.path.getsize(path) / 2**20
    restored, load_ms = host_ms(lambda: checkpoint.load_chunked_checkpoint(path))
    os.remove(path)
    round_trip = bit_identical(rt.trace_chunked(restored, oo, dd),
                               rt.trace_chunked(chunks, oo, dd), "checkpoint round trip")
    round_trip = round_trip and torch.equal(restored.tables, chunks.tables)
    del restored, chunks, tree, many, scene
    torch.cuda.empty_cache()

    emit("chunked_path", triangles=4193408, chunks=S, chunk_capacity=163840,
         triangles_per_chunk_padded=cbvh_capacity, builder="sah",
         width=W, height=H, shadows=True, png=png, nvidia_smi=smi,
         ingest_ms_host_clock=ingest_ms, build_ms_host_clock=build_ms,
         frame_ms=frame_ms, k1_launches_per_frame=frame_launches,
         table_mb=table_mb, hit_fraction=hit_fraction,
         isolated_miss_pixels_checked_by_brute_force=cracks,
         trace_chunked_4096_rays={"cuda4_bit_identical_to_plain4": kernel_vs_plain,
                                  "parity_vs_brute_force": vs_brute},
         trace_chunked_frame_rays=frame_vs_plain,
         one_tree_vs_chunks_1m={
             "triangles": 1048352, "chunks": S1, "width": W, "height": H, "shadows": True,
             "build_ms_host_clock": {"one_tree_sah_free": tree_build_ms,
                                     "chunks_sah": chunks_build_ms},
             "frame_ms_in_turns": turns,
             "chunks_vs_one_tree_fraction_off_by_more_than_2_of_255": frac_chunks_vs_tree},
         bvh2_chunks_1m={"build_ms_host_clock": chunks2_build_ms,
                         "k2_launches_per_frame": 2 * S1, "frame_ms": bvh2_frame_ms,
                         "cuda2_bit_identical_to_plain2": bvh2_vs_plain,
                         "frame_rays": bvh2_frame_vs_plain,
                         "vs_bvh4_chunks_fraction_off_by_more_than_2_of_255": frac_bvh2},
         checkpoint_round_trip_1m={"equal": round_trip, "file_mb": file_mb,
                                   "save_ms": save_ms, "load_ms": load_ms},
         timing="frames: CUDA events, median of 3 after a warm-up; builds and the "
                "checkpoint: host clock to a synchronize",
         seconds=time.perf_counter() - t_phase)
    return frame_launches


def run_probe_slice(smi, timer):
    """The measurement path: the probe kernels P1 and P2 of
    ``csrc/kernel_probe.cu`` against their plain versions at a small count,
    then the entry point's ``main`` at ``--iters 20000`` with the launch
    counts set to 0 just before and read just after.  Emits the phases
    ``probe_vs_plain`` and ``probe_path`` and returns the two entries of the
    ``kernels`` line."""
    from unitysimpleraytracing_tpu_torch.benchmarks import kernel_probe as kp

    P1, P2 = kp.probe_kernel, kp.dma_probe_kernel
    seed, small = 0, 256
    tab = kp.make_table(seed)

    # ---- probe_vs_plain -----------------------------------------------------
    cases, err = [], {"p1": 0.0, "p2": 0.0}
    for name in kp.P1_VARIANTS:
        got = P1(name, tab, small)
        torch.cuda.synchronize()
        want = kp.run_probe_plain(name, tab, small)
        assert torch.equal(got, want), f"P1 {name}: kernel {float(got)} != plain {float(want)}"
        err["p1"] = max(err["p1"], max_abs_diff(got, want))
        cases.append({"probe": name, "iters": small, "value": float(got), "bit_identical": True})
    for name, (depth, rpr) in kp.P2_VARIANTS.items():
        # The timed (chain-neutral) table and one whose data does steer the chain.
        for neutral in (True, False):
            table = kp.make_dma_table(seed, kp.L2_ROWS, rpr, chain_neutral=neutral)
            rounds = small // depth
            got = P2(table, depth, rpr, rounds)
            torch.cuda.synchronize()
            want = kp.run_dma_probe_plain(table, depth, rpr, rounds)
            assert torch.equal(got, want), f"P2 {name}: kernel {float(got)} != plain {float(want)}"
            err["p2"] = max(err["p2"], max_abs_diff(got, want))
            cases.append({"probe": name, "rounds": rounds, "depth": depth,
                          "data_steers_the_chain": not neutral, "value": float(got),
                          "bit_identical": True})
        del table
    # P2 at the path's other shape: a table five times the L2, one per row width.
    rows_devmem = 2000
    for rpr in sorted({rpr for _, rpr in kp.P2_VARIANTS.values()}):
        table = kp.make_dma_table(seed, kp.DEVMEM_ROWS, rpr)
        for name, (depth, name_rpr) in kp.P2_VARIANTS.items():
            if name_rpr != rpr:
                continue
            rounds = rows_devmem // depth
            got = P2(table, depth, rpr, rounds)
            torch.cuda.synchronize()
            want = kp.run_dma_probe_plain(table, depth, rpr, rounds)
            assert torch.equal(got, want), (
                f"P2 {name}_devmem: kernel {float(got)} != plain {float(want)}")
            err["p2"] = max(err["p2"], max_abs_diff(got, want))
            cases.append({"probe": name + "_devmem", "rounds": rounds, "depth": depth,
                          "table_rows": int(table.shape[0]), "value": float(got),
                          "bit_identical": True})
        del table
    emit("probe_vs_plain",
         tolerance="bit-identical: integer-valued float32 tables, every sum below 2^24, "
                   "-fmad=false",
         cases=cases, max_abs_err=err, nvidia_smi=smi)

    # ---- probe_path: the entry point, counts 0 just before, read just after --
    iters = 20000
    P1.launches = P2.launches = 0
    lines = kp.main(["--iters", str(iters), "--seed", str(seed)])
    torch.cuda.synchronize()
    launches = {"kernel_probe_p1": P1.launches, "kernel_probe_p2": P2.launches}
    per_probe = 1 + 2 * kp.SLOPE_REPS  # a warm-up, then SLOPE_REPS pairs (N, 4N)
    assert launches == {"kernel_probe_p1": len(kp.P1_VARIANTS) * per_probe,
                        "kernel_probe_p2": 2 * len(kp.P2_VARIANTS) * per_probe}, launches
    by_name = {ln["probe"]: ln for ln in lines}
    assert set(kp.P1_VARIANTS) <= set(by_name)
    assert all(n in by_name and n + "_devmem" in by_name for n in kp.P2_VARIANTS)
    for ln in lines:
        assert np.isfinite(ln["value"]) and ln.get("ns_per_iter", ln.get("ns_per_row")) > 0, ln
    # A probe's output is a closed form where its loop has one.
    assert by_name["empty"]["value"] == iters
    assert by_name["reduce_sum_8x128"]["value"] == 1024.0 * iters
    rows = torch.from_numpy((np.arange(iters) * 37 + 11) & 4095).cuda()
    # 32 fetches = each of a row's 16 columns twice.
    assert by_name["fetch_x32"]["value"] == 2.0 * float(tab.sum(1)[rows].double().sum())
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    emit("probe_path", iters=iters, seed=seed,
         ns_per_iter={n: by_name[n]["ns_per_iter"] for n in kp.P1_VARIANTS},
         ns_per_row_l2_resident={n: by_name[n]["ns_per_row"] for n in kp.P2_VARIANTS},
         ns_per_row_device_memory={n: by_name[n + "_devmem"]["ns_per_row"]
                                   for n in kp.P2_VARIANTS},
         values={n: ln["value"] for n, ln in by_name.items()},
         launches_on_the_path=launches,
         timing=lines[0]["timing"], clocks_max_sm_and_now=clocks, nvidia_smi=smi)

    # ---- the two entries of the kernels line ---------------------------------
    # Each probe kernel at one shape of the path, as the path launches it
    # (warm: one block or one warp on a table that is already in the caches),
    # timed beside its plain version and held against it at that count too.
    def entry(name, probe, replaces, fn, plain, shape, min_bytes, ops):
        kept = {}
        ms = timer.median_ms(lambda: kept.update(kernel=fn()), iters=5)
        plain_ms = timer.median_ms(lambda: kept.update(plain=plain()), iters=1, warmup=0)
        assert torch.equal(kept["kernel"], kept["plain"]), (
            f"{name} {probe} at the path's count: kernel {float(kept['kernel'])} != "
            f"plain {float(kept['plain'])}")
        key = "p1" if name.endswith("p1") else "p2"
        err[key] = max(err[key], max_abs_diff(kept["kernel"], kept["plain"]))
        t_bytes = min_bytes / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
        return {
            "name": name, "route": "cuda",
            "source": "unitysimpleraytracing_tpu_torch/csrc/kernel_probe.cu",
            "replaces": replaces, "probe": probe, "launches": launches[name],
            "max_abs_err": err[key],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "shape": shape,
            # A probe is a serial chain by definition: its least time is its
            # dependent operations times their latency, not this roofline.
            "serial_by_definition": True,
        }

    table = kp.make_dma_table(seed, kp.L2_ROWS, 1)
    rounds = kp.dma_rounds(iters, 1)
    return [
        entry("kernel_probe_p1", "fetch_x32",
              "benchmarks/kernel_probe.py:36",
              lambda: P1("fetch_x32", tab, iters),
              lambda: kp.run_probe_plain("fetch_x32", tab, iters),
              f"{iters} iterations x 32 fetches over a (4096, 16) float32 table -> 1 float32",
              tab.numel() * 4 + 4, 32 * iters),
        entry("kernel_probe_p2", "dma_row512_serial",
              "benchmarks/kernel_probe.py:133",
              lambda: P2(table, 1, 1, rounds),
              lambda: kp.run_dma_probe_plain(table, 1, 1, rounds),
              f"{rounds} rounds x 1 row of 512 bytes from a ({kp.L2_ROWS}, 128) float32 "
              "table -> 1 float32",
              rounds * 512 + 4, rounds),
    ]


def run_sah_path(rt, timer, smi, tex, bg, W, H):
    """The default build at full width: ``build_bvh(scene)`` with no
    ``builder`` (free-order sweep SAH), ``"sah"`` and ``"karras"`` on the
    260,642-triangle scene, the frame and both traversal kernels on each tree,
    ``validate=True`` on the default tree, one ``"sah"`` build of 1,048,352
    triangles.  The drive comes first, with the launch counts set to 0 just
    before and read just after.  Emits the phase ``sah_path``."""
    from unitysimpleraytracing_tpu_torch import constants as C
    from unitysimpleraytracing_tpu_torch.core.camera import generate_rays
    from unitysimpleraytracing_tpu_torch.ops import dispatch, lbvh, trace_bvh2, trace_bvh4
    from unitysimpleraytracing_tpu_torch.utils import parity

    K1, K2 = trace_bvh4.traverse_bvh4, trace_bvh2.traverse_bvh2
    scene = rt.build_scene(rt.terrain_mesh(res=362, size=160.0, amplitude=20.0, seed=1))
    assert scene.count == 260642
    cam = rt.make_camera(eye=(110.0, 90.0, 140.0), target=(0.0, 0.0, 0.0), width=W, height=H)
    n_rays = W * H

    # -- the drive: counts 0 just before, read just after -----------------------
    K1.launches = K2.launches = 0
    default = rt.build_bvh(scene)
    frames = {None: rt.render_frame(scene, default, cam, tex, bg, shadows=True)}
    frame_cuda2 = rt.render_frame(scene, default, cam, tex, bg, impl="cuda2", shadows=True)
    torch.cuda.synchronize()
    launches = {"trace_bvh4": K1.launches, "trace_bvh2": K2.launches}
    assert launches == {"trace_bvh4": 2, "trace_bvh2": 2}, launches

    trees = {None: default}
    for builder in ("sah", "karras"):
        trees[builder] = rt.build_bvh(scene, builder=builder)
        frames[builder] = rt.render_frame(scene, trees[builder], cam, tex, bg, shadows=True)
    bvh_bits_equal(parity, rt.build_bvh(scene, builder="sah_free"), default,
                   "builder=None vs builder='sah_free'")

    def label(builder):
        return "default (sah_free)" if builder is None else builder

    # -- what each tree is ---------------------------------------------------------
    def sah_cost(bvh):
        n = bvh.count
        e = (bvh.node_aabb_max - bvh.node_aabb_min)[: n - 1].double()
        area = e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2] + e[:, 2] * e[:, 0]
        return float(area.sum() / area[0])

    def max_depth(bvh):
        return int(lbvh.attach_diagnostics(bvh).depth.max())

    shape = {}
    for builder, bvh in trees.items():
        depth = max_depth(bvh)
        # K2 pushes at most one entry more than it pops per level of internal
        # nodes, K1 at most three per BVH4 level (two binary levels): a walk
        # cannot need more stack than this, whatever the rays.
        shape[label(builder)] = {
            # A SAH build loop takes one iteration (one read-back) per tree level.
            "levels_of_the_build_loop": 0 if builder == "karras" else depth + 1,
            "max_depth": depth,
            "sah_cost": sah_cost(bvh),
            "stack_entries_k2_can_need": depth + 1,
            "stack_entries_k1_can_need": 3 * (depth // 2 + 1) + 1,
            "stack_entries_of_both_kernels": C.TRAVERSAL_STACK_DEPTH,
        }
        if depth + 1 > C.TRAVERSAL_STACK_DEPTH:
            raise dispatch.CapacityError(
                f"the {label(builder)} tree is {depth} levels deep: more than the "
                f"{C.TRAVERSAL_STACK_DEPTH}-entry stacks of the traversal kernels can hold")

    # -- validate=True on the default tree -------------------------------------------
    t0 = time.perf_counter()
    validated = rt.build_bvh(scene, validate=True)
    torch.cuda.synchronize()
    validate_s = time.perf_counter() - t0
    bvh_bits_equal(parity, validated, rt.build_bvh(scene, diagnostics=True),
                   "validate=True vs diagnostics=True, default builder")
    del validated

    # -- frames and hits under the parity contract -------------------------------------
    hits = {b: rt.render_hits(scene, bvh, cam) for b, bvh in trees.items()}
    contract = {}
    for builder in (None, "sah"):
        st = parity.assert_hit_parity(np_hits(hits[builder]), np_hits(hits["karras"]))
        st["image_fraction_off_by_more_than_2_of_255"] = parity.compare_images(
            parity.frame_to_uint8(rt.frame_to_image(frames[builder])),
            parity.frame_to_uint8(rt.frame_to_image(frames["karras"])),
            f"{label(builder)} frame vs karras frame")
        st["frame_values_differing"] = int((frames[builder] != frames["karras"]).sum())
        contract[f"{label(builder)} vs karras"] = st
    contract["default tree, cuda2 frame vs cuda4 frame: values differing"] = int(
        (frame_cuda2 != frames[None]).sum())
    del frame_cuda2

    # -- both kernels on each tree: against plain on the default tree, then timed ------
    o, d = generate_rays(cam)
    o = dispatch._tile_major(o, H, W, 32).contiguous()
    d = dispatch._tile_major(d, H, W, 32).contiguous()
    tables = {b: (trace_bvh4.prepare_tables4(scene, bvh), trace_bvh2.prepare_tables(scene, bvh))
              for b, bvh in trees.items()}
    vs_plain = {}
    for module, table in ((trace_bvh4, tables[None][0]), (trace_bvh2, tables[None][1])):
        st, _, _, _ = compare_kernel_with_plain(
            f"{module.KERNEL_NAME}: primary rays over the default tree", module, parity,
            table, o, d)
        vs_plain[module.KERNEL_NAME] = st
    kernels = {label(b): {} for b in trees}
    for b, (t4, t2) in tables.items():
        for name, fn, table in (("trace_bvh4", K1, t4), ("trace_bvh2", K2, t2)):
            _, steps = fn(table, o, d, count_steps=True)
            kernels[label(b)][name] = {
                "records": int(table.shape[0]),
                "records_per_ray": int(steps.sum()) / n_rays, "max_pops": int(steps.max())}
    order = (None, "sah", "karras", "karras", "sah", None)
    kernel_turns = {"trace_bvh4": [], "trace_bvh2": []}
    for b in order:
        t4, t2 = tables[b]
        kernel_turns["trace_bvh4"].append(
            [label(b), timer.median_ms(lambda: K1(t4, o, d), iters=7, cold=True)])
        kernel_turns["trace_bvh2"].append(
            [label(b), timer.median_ms(lambda: K2(t2, o, d), iters=7, cold=True)])
    frame_turns = [
        [label(b), timer.median_ms(
            lambda: rt.render_frame(scene, trees[b], cam, tex, bg, shadows=True), iters=5)]
        for b in order]
    del tables, hits, frames, o, d

    # -- the builds in turns -------------------------------------------------------------
    build_turns = [
        [label(b), timer.median_ms(lambda: rt.build_bvh(scene, builder=b), iters=3)]
        for b in order]
    torch.cuda.reset_peak_memory_stats()
    rt.build_bvh(scene)
    build_peak_gb = torch.cuda.max_memory_allocated() / 2**30
    del trees, default, scene

    # -- one "sah" build of the 1,048,352-triangle scene -----------------------------------
    scene_1m = rt.build_scene(rt.terrain_mesh(res=725, size=300.0, amplitude=30.0, seed=0))
    assert scene_1m.count == 1048352
    bvh_1m = rt.build_bvh(scene_1m, builder="sah")
    depth_1m = max_depth(bvh_1m)
    one_m = {"triangles": scene_1m.count, "builder": "sah",
             "levels_of_the_build_loop": depth_1m + 1, "max_depth": depth_1m,
             "sah_cost": sah_cost(bvh_1m),
             "build_ms": timer.median_ms(lambda: rt.build_bvh(scene_1m, builder="sah"), iters=2)}
    cam_1m = rt.make_camera(eye=(210.0, 170.0, 260.0), target=(0.0, 0.0, 0.0),
                            width=512, height=512)
    one_m["hits_vs_karras_tree"] = parity.assert_hit_parity(
        np_hits(rt.render_hits(scene_1m, bvh_1m, cam_1m)),
        np_hits(rt.render_hits(scene_1m, rt.build_bvh(scene_1m, builder="karras"), cam_1m)))

    emit("sah_path", triangles=260642, width=W, height=H,
         default_builder_is_sah_free_bit_for_bit=True,
         launches_on_the_path=launches, trees=shape,
         build_ms_in_turns=build_turns, build_peak_gb=build_peak_gb,
         validate_true_seconds_default_tree=validate_s,
         parity_contract=contract, kernels_vs_plain_on_the_default_tree=vs_plain,
         kernels_per_tree=kernels, kernel_ms_in_turns_cold_l2=kernel_turns,
         frame_ms_with_shadows_in_turns=frame_turns, one_sah_build_at_1m=one_m,
         timing="CUDA events; builds median of 3 (2 at 1,048,352), kernels median of 7 "
                "cold L2, frames median of 5, each after a warm-up",
         nvidia_smi=smi)
    return launches


def run_parity_scale(rt, smi) -> None:
    """The card's three traversal kernels held to the JAX package's answer at
    config 2 (``bench.py:118-124``: 65,522 triangles, the default tree,
    512x512), stored as ``tests/golden/torch_config2_hits_jax.npz`` (hit mask
    and ids; the CPU suite holds that file to the JAX package bit for bit).
    K1 and K2 through ``render_hits(impl="cuda4")`` and ``"cuda2"``, K1c
    through ``trace_rays(..., tables=compress_tables4(...))`` on the same
    rays, each driven with its count set to 0 just before and read just
    after.  Each answer must meet ``assert_hit_parity_at_scale``, the crack
    rule (t, u, v of the reference are float64 of JAX's triangle on the
    card's ray: the file stores no t), with exactly the divergent ray the
    CPU suite finds (108,203, where float64 sides with the port); and each
    must equal its plain version on the same tree and rays (``plain4``; K1c
    on its compressed table; ``plain2`` for K2) bit for bit where tri agrees,
    tri differing only at exact-t ties.  Emits ``parity_scale``: per kernel
    the divergent rays, the side float64 agrees with on each, the largest
    edge distance; and how many of the card's ray directions differ bitwise
    from ``generate_rays`` on the CPU."""
    from unitysimpleraytracing_tpu_torch.core.camera import generate_rays
    from unitysimpleraytracing_tpu_torch.ops import dispatch, trace_bvh2, trace_bvh4
    from unitysimpleraytracing_tpu_torch.utils import parity

    t_phase = time.perf_counter()
    K1, K2 = trace_bvh4.traverse_bvh4, trace_bvh2.traverse_bvh2
    W = H = 512
    cam_kw = dict(eye=(55.0, 45.0, 70.0), target=(0.0, 0.0, 0.0), width=W, height=H,
                  fov_deg=60.0)
    scene = rt.build_scene(rt.terrain_mesh(res=182, size=80.0, amplitude=9.0, seed=0))
    bvh = rt.build_bvh(scene)
    cam = rt.make_camera(**cam_kw)
    o, d = generate_rays(cam)
    o_cpu, d_cpu = generate_rays(rt.make_camera(**cam_kw, device="cpu"))
    compressed = trace_bvh4.compress_tables4(trace_bvh4.prepare_tables4(scene, bvh))
    o_tile, d_tile = (dispatch._tile_major(x, H, W, 32).contiguous() for x in (o, d))
    torch.cuda.synchronize()

    K1.launches = K2.launches = K1.compressed_launches = 0
    answers = {
        "trace_bvh4": rt.render_hits(scene, bvh, cam, impl="cuda4"),
        "trace_bvh2": rt.render_hits(scene, bvh, cam, impl="cuda2"),
        "trace_bvh4_compressed": dispatch.trace_rays(scene, bvh, o_tile, d_tile,
                                                     tables=compressed),
    }
    torch.cuda.synchronize()
    launches = {"trace_bvh4": K1.launches, "trace_bvh2": K2.launches,
                "trace_bvh4_compressed": K1.compressed_launches}
    assert launches == dict.fromkeys(answers, 1), f"parity_scale launches: {launches}"
    plain = {
        "trace_bvh4": rt.render_hits(scene, bvh, cam, impl="plain4"),
        "trace_bvh2": rt.render_hits(scene, bvh, cam, impl="plain2"),
        "trace_bvh4_compressed": dispatch.trace_rays(scene, bvh, o_tile, d_tile,
                                                     impl="plain4", tables=compressed),
    }

    def row_major(h):
        return SimpleNamespace(
            **{f: dispatch._row_major(getattr(h, f), H, W, 32) for f in ("t", "tri", "u", "v")})

    for k in (answers, plain):
        k["trace_bvh4_compressed"] = row_major(k["trace_bvh4_compressed"])

    on, dn = o.cpu().numpy(), d.cpu().numpy()
    tris = scene.triangles
    a, b, c = (x[:scene.count].cpu().numpy() for x in (tris.a, tris.b, tris.c))
    mask, tri, _ = parity.load_hit_fixture(os.path.join(GOLDEN_DIR, "torch_config2_hits_jax.npz"))
    ref = parity.hits_from_ids(mask, tri, a, b, c, on, dn)
    kernels = {}
    for name, hits in answers.items():
        got = np_hits(hits)
        vs_plain = parity.assert_hit_parity(got, np_hits(plain[name]), exact=True)
        st = parity.assert_hit_parity_at_scale(got, ref, a, b, c, on, dn)
        assert st["divergent"] == [108203] and st["agrees"] == ["got"], (
            f"{name}: divergent rays {st['divergent']}, float64 with {st['agrees']}; "
            f"the CPU suite finds [108203], with the port")
        kernels[name] = {"launches": launches[name], "hit_rays": int((got.t != MAX_FLOAT).sum()),
                         "tri_ties_vs_plain": vs_plain["tri_ties"], **st}
    emit("parity_scale", triangles=scene.count, width=W, height=H, tree="default (sah_free)",
         reference="tests/golden/torch_config2_hits_jax.npz (JAX render_hits on the CPU)",
         reference_hits=int(mask.sum()),
         rule="assert_hit_parity_at_scale: a ray may diverge only where float64 hits it "
              f"within max(EDGE_EPS={parity.EDGE_EPS}, 4 float32 eps x uv_condition) of an "
              "edge another triangle shares and one side agrees with float64 (in id, or "
              "across that edge at its t); every other ray under assert_hit_parity (t "
              "relative 4e-6, x grazing_factor where both hit one triangle; u, v within "
              "4 float32 eps x uv_condition); divergent must be [108203] with float64 "
              "on the card's side; each kernel equal to its plain version (plain4, K1c's "
              "on its table, plain2) bit for bit where tri agrees, tri only at exact-t ties",
         kernels=kernels,
         dirs_differing_bitwise_from_cpu=int((d.cpu() != d_cpu).any(dim=1).sum()),
         origins_differing_bitwise_from_cpu=int((o.cpu() != o_cpu).any(dim=1).sum()),
         rays=W * H, seconds=time.perf_counter() - t_phase, nvidia_smi=smi)


# What ``parity_frame`` must find against the JAX package's fixtures (found
# by the phase's first full run on an H100): the divergent
# rays of each kernel's primary hits (crack rule), of K1's shadow mask
# (occlusion rule) and the pixels more than 1/255 off (frame rule).  The
# card's rays are not the CPU's (1,123 of config 2's 262,144 directions
# differ), so its lists are not the CPU suite's.
_CRACKS3 = [582869, 642104, 809183, 956884, 991632, 1014266, 1060878, 1070837, 1122217,
            1124269, 1220518]
PARITY_FRAME_PINS = {
    "config2": {"trace_bvh4": [108203], "shadow": [], "frame_beyond_1": [108203]},
    "config3": {
        "trace_bvh4": _CRACKS3, "trace_bvh2": _CRACKS3,
        "shadow":
            [473357, 473359, 479132, 481054, 484897, 490662, 502191, 505970, 511799, 511959,
             517565, 517727, 521410, 523493, 523494, 527180, 529104, 530913, 531185, 532955,
             534749, 538723, 538724, 540492, 540497, 544491, 554100, 554101, 561789, 563476,
             584574, 588407, 590322, 590323, 609490, 613327, 615104, 649787, 653625, 682412,
             684331, 720790, 726544, 1001725, 1134089],
        "frame_beyond_1":
            [492496, 582869, 642104, 653468, 809183, 891605, 892130, 930446, 956884, 991632,
             1014266, 1060878, 1070837, 1122217, 1124269, 1220518, 1243557, 1245425]},
    "config4": {"trace_bvh4": []},
}


def frame_inputs(scene, cam):
    """The real triangles (a, b, c) of ``scene`` and the primary rays of
    ``cam`` (row-major), as numpy on the host."""
    from unitysimpleraytracing_tpu_torch.core.camera import generate_rays

    tris = scene.triangles
    a, b, c = (x[:scene.count].cpu().numpy() for x in (tris.a, tris.b, tris.c))
    o, d = (x.cpu().numpy() for x in generate_rays(cam))
    return a, b, c, o, d


def hold_to_fixture(a, b, c, o, d, fixture, hits, plain, shadow=None, shadow_rays=None,
                    frame=None):
    """One configuration's card answers held to a JAX fixture (``a``, ``b``,
    ``c``: the real triangles; ``o``, ``d``: the card's primary rays in the
    order of the hits, as numpy): each kernel's primary hits (``hits``: name
    → HitRecord) under the crack rule and to its plain version (``plain``:
    name → HitRecord) bit for bit where tri agrees; K1's shadow mask
    (``shadow``, on the card's own ``shadow_rays`` = (origins, dirs,
    origin bound)) under the occlusion rule where both sides hit the same
    triangle; the frame (``frame``) under the frame rule.  ``shadow`` and
    ``frame`` None: primary hits only (a fixture without ``shadow_bits`` or
    ``frame_u8``).

    The fixture's shadow flags were traced on JAX's own shadow rays, whose
    origins differ in the last bits from the card's, so the occlusion rule
    judges both sides against float64 of the card's rays: an ``agrees`` of
    ``"ref"`` says JAX's flag is float64's on the card's ray."""
    from unitysimpleraytracing_tpu_torch.utils import parity

    mask, tri, jshadow = parity.load_hit_fixture(fixture)
    ref = parity.hits_from_ids(mask, tri, a, b, c, o, d)
    out = {"hit_rays_jax": int(mask.sum())}
    for name, h in hits.items():
        got = np_hits(h)
        vs_plain = parity.assert_hit_parity(got, np_hits(plain[name]), exact=True)
        st = parity.assert_hit_parity_at_scale(got, ref, a, b, c, o, d)
        out[name] = {"hit_rays": int((got.t != MAX_FLOAT).sum()),
                     "tri_ties_vs_plain": vs_plain["tri_ties"],
                     **{k: st[k] for k in ("divergent", "agrees", "f64_tri", "across_edge",
                                           "max_edge_distance", "grazing_t", "tri_ties",
                                           "tie_rays")}}
    explained = out["trace_bvh4"]["divergent"] + out["trace_bvh4"]["tie_rays"]
    if shadow is not None:
        k1 = np_hits(hits["trace_bvh4"])
        so, sd, bound = shadow_rays
        so, sd = so.cpu().numpy(), sd.cpu().numpy()
        card_shadow = shadow.cpu().numpy()
        both = np.flatnonzero((k1.t != MAX_FLOAT) & mask & (k1.tri == tri))
        occ = parity.assert_occlusion_parity_at_scale(
            card_shadow[both], jshadow[both], a, b, c, so[both], sd[both], float(bound))
        out["shadow"] = {
            "occluded_rays": {"card": int(card_shadow.sum()), "jax": int(jshadow.sum())},
            "divergent": both[occ["divergent"]].tolist(), "agrees": occ["agrees"],
            "edge_distance": occ["edge_distance"],
            "near_threshold": both[occ["near_threshold"]].tolist()}
        explained += out["shadow"]["divergent"]
    if frame is not None:
        with np.load(fixture) as z:
            jframe = z["frame_u8"]
        out["frame"] = parity.assert_frame_parity_at_scale(
            parity.frame_to_uint8(frame.cpu().numpy()), jframe, explained)
    return out


def run_parity_frame(rt, smi, out_dir) -> None:
    """The card held to the JAX package's committed answers for the shadowed
    frame and the animated frame (``tests/golden/torch_config{2_frame,3,4}
    _jax.npz``; the CPU suite holds each file to the JAX package bit for
    bit), each configuration driven with the launch counts set to 0 just
    before and read just after:

    - config 2 (65,522 triangles, 512x512, the default tree):
      ``render_frame(impl="cuda4", shadows=True)``, ``render_hits`` and
      ``render._shadow_mask`` (K1 nearest-hit and any-hit);
    - config 3 (260,642 triangles, 1920x1056, the default tree): the same
      through K1, and ``render_hits(impl="cuda2")`` (K2);
    - config 4 (the config-2 scene deformed by ``0.5·sin(0.37·x + phase)``
      on y, positions made in numpy as the CPU suite makes them): the refit
      at phase 0.7 against the fixture's SHA-256 of JAX's node boxes, and
      ``make_animated_renderer(impl="cuda4")`` at 0.9 (K1).

    Primary hits go under the crack rule, K1's shadow mask under the
    occlusion rule (on the card's shadow rays, where both sides hit the same
    triangle), the frames under the frame rule; each kernel is held bit for
    bit to its plain version on the same rays (``plain4``, ``plain2``; the
    shadow mask to ``plain4``'s on the card's shadow rays).  Emits
    ``parity_frame`` and writes it to ``parity_frame.json`` under ``--out``;
    then asserts the divergent lists of ``PARITY_FRAME_PINS``."""
    from unitysimpleraytracing_tpu_torch.ops import trace_bvh2, trace_bvh4
    from unitysimpleraytracing_tpu_torch.pipeline import render
    from unitysimpleraytracing_tpu_torch.utils import parity

    t_phase = time.perf_counter()
    K1, K2 = trace_bvh4.traverse_bvh4, trace_bvh2.traverse_bvh2
    tex = rt.solid_texture((0.8, 0.7, 0.6, 1.0))
    bg = np.asarray([0.1, 0.1, 0.12], np.float32)
    report = {}

    configs = {
        "config2": (dict(res=182, size=80.0, amplitude=9.0, seed=0),
                    dict(eye=(55.0, 45.0, 70.0), width=512, height=512)),
        "config3": (dict(res=362, size=160.0, amplitude=20.0, seed=1),
                    dict(eye=(110.0, 90.0, 140.0), width=1920, height=1056)),
    }
    built = {}
    for name, (mesh_kw, cam_kw) in configs.items():
        t0 = time.perf_counter()
        scene = rt.build_scene(rt.terrain_mesh(**mesh_kw))
        bvh = rt.build_bvh(scene)
        cam = rt.make_camera(target=(0.0, 0.0, 0.0), fov_deg=60.0, **cam_kw)
        built[name] = (scene, bvh, cam)
        torch.cuda.synchronize()
        K1.launches = K2.launches = 0
        frame = rt.render_frame(scene, bvh, cam, tex, bg, impl="cuda4", shadows=True)
        hits = {"trace_bvh4": rt.render_hits(scene, bvh, cam, impl="cuda4")}
        if name == "config3":
            hits["trace_bvh2"] = rt.render_hits(scene, bvh, cam, impl="cuda2")
        shadow = render._shadow_mask(scene, bvh, hits["trace_bvh4"], "cuda4", cam)
        torch.cuda.synchronize()
        launches = {"trace_bvh4": K1.launches, "trace_bvh2": K2.launches}
        assert launches == {"trace_bvh4": 4, "trace_bvh2": len(hits) - 1}, (
            f"parity_frame {name} launches: {launches}")
        plain = {k: rt.render_hits(scene, bvh, cam, impl=k.replace("trace_bvh", "plain"))
                 for k in hits}
        assert torch.equal(shadow, render._shadow_mask(scene, bvh, hits["trace_bvh4"], "plain4",
                                                       cam)), "K1's shadow mask differs from plain4's"
        fixture = os.path.join(GOLDEN_DIR, f"torch_{name}{'_frame' if name == 'config2' else ''}"
                                           "_jax.npz")
        report[name] = {
            "triangles": scene.count, "rays": cam.width * cam.height, "launches": launches,
            **hold_to_fixture(*frame_inputs(scene, cam), fixture, hits, plain, shadow,
                              render.shadow_rays(scene, bvh, hits["trace_bvh4"], cam), frame),
            "seconds": time.perf_counter() - t0}
        del frame, hits, shadow, plain

    # Config 4: the config-2 scene and default tree, deformed.
    t0 = time.perf_counter()
    scene, bvh, cam = built["config2"]
    fixture = os.path.join(GOLDEN_DIR, "torch_config4_jax.npz")
    with np.load(fixture) as z:
        want = {k: str(z[k]) for k in ("refit_sha256", "refit_positions_sha256",
                                       "frame_positions_sha256")}
    corners = [x.cpu().numpy() for x in (scene.triangles.a, scene.triangles.b, scene.triangles.c)]
    pos = {ph: parity.config4_positions(*corners, ph) for ph in (0.7, 0.9)}
    digests = {"refit_positions_sha256": parity.bits_digest(pos[0.7]),
               "frame_positions_sha256": parity.bits_digest(pos[0.9])}
    for k, v in digests.items():
        assert v == want[k], (f"config 4: {k} {v} is not the fixture's {want[k]}: this "
                              "numpy rounds float32 sin otherwise")
    refit = rt.refit_bvh(rt.deform_scene(scene, torch.from_numpy(pos[0.7]).cuda()), bvh)
    refit_digest = parity.bits_digest(refit.node_aabb_min.cpu().numpy(),
                                      refit.node_aabb_max.cpu().numpy())
    assert refit_digest == want["refit_sha256"], "config 4: the refit boxes differ from JAX's"
    anim = rt.make_animated_renderer(scene, bvh, cam, impl="cuda4")
    p9 = torch.from_numpy(pos[0.9]).cuda()
    torch.cuda.synchronize()
    K1.launches = 0
    hits = {"trace_bvh4": anim(p9)}
    torch.cuda.synchronize()
    launches = {"trace_bvh4": K1.launches}
    assert launches == {"trace_bvh4": 1}, f"parity_frame config4 launches: {launches}"
    plain = {"trace_bvh4": rt.make_animated_renderer(scene, bvh, cam, impl="plain4")(p9)}
    deformed = rt.deform_scene(scene, p9)
    report["config4"] = {
        "triangles": scene.count, "rays": cam.width * cam.height, "launches": launches,
        "refit_sha256": refit_digest, "refit_bit_identical_to_jax": True, **digests,
        **hold_to_fixture(*frame_inputs(deformed, cam), fixture, hits, plain),
        "seconds": time.perf_counter() - t0}
    del built, scene, bvh, cam, hits, plain, deformed

    line = {"phase": "parity_frame", "tree": "default (sah_free)",
            "references": {k: f"tests/golden/torch_{k}_jax.npz"
                           for k in ("config2_frame", "config3", "config4")},
            "texture": [0.8, 0.7, 0.6, 1.0], "background": bg.tolist(),
            "rules": "primary hits: assert_hit_parity_at_scale (crack rule); K1's shadow "
                     "mask: assert_occlusion_parity_at_scale (a flag may differ only where "
                     "float64 puts the ray in a crack along a shared edge or a blocker at "
                     "the segment's end, on the card's shadow rays where both sides hit "
                     "one triangle: JAX's flags, traced on JAX's own rays, are judged "
                     "against float64 of the card's rays, so agrees 'ref' means JAX's flag "
                     "is float64's on the card's ray); K1's shadow mask bit for bit to "
                     "plain4's on the card's shadow rays; frames: assert_frame_parity_at_scale (every pixel "
                     "more than 1/255 off on a ray those rules list, and the golden bound); "
                     "each kernel bit for bit to its plain version where tri agrees",
            **report, "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi}
    print(json.dumps(line), flush=True)
    with open(os.path.join(out_dir, "parity_frame.json"), "w") as f:
        json.dump(line, f, indent=1)
    for name, pins in PARITY_FRAME_PINS.items():
        for key, want_rays in pins.items():
            got = (report[name]["frame"]["beyond_1"] if key == "frame_beyond_1"
                   else report[name][key]["divergent"])
            assert got == want_rays, f"parity_frame {name} {key}: {got}, pinned {want_rays}"


# What ``parity_large`` must find against the JAX package's fixtures
# (``tests/golden/torch_{1m,config5_chunked,4m_chunked}_jax.npz``), measured
# by the phase's first full run on an H100: per configuration, K1's divergent
# primary rays (crack rule), its divergent shadow flags (occlusion rule) and
# the pixels more than 1/255 off (frame rule; 4m_chunked holds no frame).
PARITY_LARGE_PINS = {
    "1m": {"trace_bvh4": [64180, 92992, 106308, 109476, 139177, 142748],
           "shadow": [114694, 115724, 118851, 122922, 127972, 128483, 147429],
           "frame_beyond_1": [64180, 92992, 106308, 109476, 122953, 139177, 142748, 153827]},
    "config5_chunked": {"trace_bvh4": [52481, 107266, 115030],
                        "shadow": [118190, 129992, 135584, 148859],
                        "frame_beyond_1": [52481, 107266, 115030, 158493]},
    # positions in the held subset of 126,720 rays (parity.frame_subset)
    "4m_chunked": {"trace_bvh4": [52928, 64660, 67371],
                   "shadow": [28101, 31899, 37249, 37730, 39654, 48809, 50726, 51206, 52648]},
}
# name -> (terrain_mesh kwargs, camera, every step-th row and column held, or
# None for the whole frame): the CPU suite's configurations.
_CAM_1M = dict(eye=(210.0, 170.0, 260.0), width=512, height=512)
PARITY_LARGE_CONFIGS = {
    "1m": (dict(res=725, size=300.0, amplitude=30.0, seed=0), _CAM_1M, None),
    "config5_chunked": (dict(res=708, size=300.0, amplitude=30.0, seed=0), _CAM_1M, None),
    "4m_chunked": (dict(res=1449, size=600.0, amplitude=60.0, seed=3),
                   dict(eye=(420.0, 340.0, 520.0), width=1920, height=1056), 4),
}


def run_parity_large(rt, smi, out_dir) -> None:
    """The card held to the JAX package's committed answers at the port's
    three largest single-card sizes (the CPU suite
    ``tests/test_torch_parity_large.py`` holds each file to the JAX package
    bit for bit, and the port's plain versions to the same rules), each
    configuration driven with K1's launch count set to 0 just before and
    read just after:

    - ``1m``: 1,048,352 triangles as one default (``sah_free``) tree,
      512x512: ``render_frame(impl="cuda4", shadows=True)``, ``render_hits``
      and ``render._shadow_mask`` (4 launches).  No K2: 1,048,352 padded to
      1024 is one past the binary records' 20-bit ids;
    - ``config5_chunked``: the bench's config-5 chunked row, 999,698
      triangles in 7 ``"sah"`` chunks at 512x512: ``render_frame_chunked``,
      ``render_hits_chunked`` and ``occluded_chunked`` on the frame's shadow
      rays (4 launches a chunk);
    - ``4m_chunked``: 4,193,408 triangles in 26 chunks at 1920x1056, the same
      three calls; held on the fixture's rays, every 4th row and column of
      the frame (126,720, ``parity.frame_subset``).

    Each scene's mesh positions and each chunked scene's partition must have
    the fixture's SHA-256s; the chunk tables' SHA-256 is compared with JAX's
    and reported (free-order and sweep SAH trees may flip a split whose two
    candidates cost the same within 1e-5, so the tables need not agree).
    Primary hits go under the crack rule, K1's shadow mask under the
    occlusion rule (on the card's shadow rays, where both sides hit
    one triangle), the frames under the frame rule; K1 is held bit for bit
    to ``plain4`` on the same rays, nearest-hit and any-hit.  Emits
    ``parity_large``, writes it to ``parity_large.json`` under ``--out``,
    then asserts the divergent lists of ``PARITY_LARGE_PINS``."""
    from unitysimpleraytracing_tpu_torch.core.camera import generate_rays
    from unitysimpleraytracing_tpu_torch.core.types import HitRecord
    from unitysimpleraytracing_tpu_torch.ops import dispatch, trace_bvh4
    from unitysimpleraytracing_tpu_torch.pipeline import chunked, render
    from unitysimpleraytracing_tpu_torch.utils import parity

    t_phase = time.perf_counter()
    K1 = trace_bvh4.traverse_bvh4
    tex = rt.solid_texture((0.8, 0.7, 0.6, 1.0))
    bg = np.asarray([0.1, 0.1, 0.12], np.float32)
    report = {}
    for name, (mesh_kw, cam_kw, step) in PARITY_LARGE_CONFIGS.items():
        t0 = time.perf_counter()
        fixture = os.path.join(GOLDEN_DIR, f"torch_{name}_jax.npz")
        with np.load(fixture) as z:
            want = {k: str(z[k]) for k in ("mesh_sha256", "partition_sha256", "tables_sha256")
                    if k in z}
        mesh = rt.terrain_mesh(**mesh_kw)
        assert parity.bits_digest(mesh.positions) == want["mesh_sha256"], (
            f"parity_large {name}: this numpy makes another mesh than the fixture's")
        scene = rt.build_scene(mesh)
        del mesh
        cam = rt.make_camera(target=(0.0, 0.0, 0.0), fov_deg=60.0, **cam_kw)
        h, w = cam.height, cam.width
        o, d = generate_rays(cam)
        entry = {"triangles": scene.count, "rays": h * w}
        if name == "1m":
            tree = rt.build_bvh(scene)
            torch.cuda.synchronize()
            K1.launches = 0
            frame = rt.render_frame(scene, tree, cam, tex, bg, impl="cuda4", shadows=True)
            hits = rt.render_hits(scene, tree, cam, impl="cuda4")
            shadow = render._shadow_mask(scene, tree, hits, "cuda4", cam)
            torch.cuda.synchronize()
            launches, want_launches = K1.launches, 4
            plain = rt.render_hits(scene, tree, cam, impl="plain4")
            plain_shadow = render._shadow_mask(scene, tree, hits, "plain4", cam)
            so, sd, bound = render.shadow_rays(scene, tree, hits, cam)
            del tree
        else:
            tree = rt.build_bvh_chunked(scene)
            S = tree.num_chunks
            entry["chunks"] = S
            entry["partition_sha256"] = parity.partition_digest(SimpleNamespace(**{
                f: getattr(tree.sscene, f).cpu() for f in parity.SHARDED_FIELDS}))
            entry["tables_sha256"] = parity.bits_digest(tree.tables.cpu().numpy())
            entry["partition_equals_jax"] = entry["partition_sha256"] == want["partition_sha256"]
            assert entry["partition_equals_jax"], f"parity_large {name}: the partition differs"
            entry["tables_equal_jax"] = entry["tables_sha256"] == want["tables_sha256"]

            def occluded(so_, sd_, bound_, impl):
                return dispatch._row_major(rt.occluded_chunked(
                    tree, dispatch._tile_major(so_, h, w, 32).contiguous(),
                    dispatch._tile_major(sd_, h, w, 32).contiguous(), impl=impl,
                    origin_bound=bound_), h, w, 32)

            torch.cuda.synchronize()
            K1.launches = 0
            frame = rt.render_frame_chunked(scene, tree, cam, tex, bg, impl="cuda4",
                                            shadows=True)
            hits = rt.render_hits_chunked(scene, tree, cam, impl="cuda4")
            so, sd, bound = chunked._shadow_rays_chunked(tree, hits, o, d)
            shadow = occluded(so, sd, bound, "cuda4") & hits.hit
            torch.cuda.synchronize()
            launches, want_launches = K1.launches, 4 * S
            if step is None:
                plain = rt.render_hits_chunked(scene, tree, cam, impl="plain4")
                plain_shadow = occluded(so, sd, bound, "plain4") & hits.hit
            else:  # K1 against plain4 on the fixture's rays alone
                rows = torch.from_numpy(parity.frame_subset(w, h, step)).cuda()
                hits = HitRecord(**{f: getattr(hits, f)[rows] for f in ("t", "tri", "u", "v")})
                o, d, so, sd, shadow = (x[rows].contiguous() for x in (o, d, so, sd, shadow))
                plain = rt.trace_chunked(tree, o, d, impl="plain4", route=False)
                plain_shadow = rt.occluded_chunked(tree, so, sd, impl="plain4",
                                                   origin_bound=bound) & hits.hit
                assert bool(torch.isfinite(frame).all()), "the 4m chunked frame is not finite"
                frame = None
            del tree
        assert launches == want_launches, f"parity_large {name} launches: {launches}"
        assert torch.equal(shadow, plain_shadow), f"{name}: K1's shadow mask differs from plain4's"
        tris = scene.triangles
        a, b, c = (x[:scene.count].cpu().numpy() for x in (tris.a, tris.b, tris.c))
        report[name] = {
            **entry, "launches": {"trace_bvh4": launches}, "held_rays": int(o.shape[0]),
            **hold_to_fixture(a, b, c, o.cpu().numpy(), d.cpu().numpy(), fixture,
                              {"trace_bvh4": hits}, {"trace_bvh4": plain}, shadow,
                              (so, sd, bound), frame),
            "seconds": time.perf_counter() - t0}
        del scene, frame, hits, shadow, plain, plain_shadow, o, d, so, sd
        torch.cuda.empty_cache()

    line = {"phase": "parity_large", "trees": "1m: default (sah_free); chunked: \"sah\"",
            "references": {k: f"tests/golden/torch_{k}_jax.npz" for k in PARITY_LARGE_CONFIGS},
            "rules": "as parity_frame: primary hits under assert_hit_parity_at_scale, K1's "
                     "shadow mask under assert_occlusion_parity_at_scale on the card's "
                     "shadow rays where both sides hit one triangle, frames under "
                     "assert_frame_parity_at_scale; K1 bit for bit to plain4 where tri "
                     "agrees, its shadow mask equal to plain4's",
            **report, "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi}
    print(json.dumps(line), flush=True)
    with open(os.path.join(out_dir, "parity_large.json"), "w") as f:
        json.dump(line, f, indent=1)
    for name, pins in PARITY_LARGE_PINS.items():
        for key, want_rays in pins.items():
            got = (report[name]["frame"]["beyond_1"] if key == "frame_beyond_1"
                   else report[name][key]["divergent"])
            assert got == want_rays, f"parity_large {name} {key}: {got}, pinned {want_rays}"


def write_obj(path: str, mesh) -> None:
    """A MeshData as an OBJ: three ``v``/``vt``/``vn`` rows a triangle, each
    float32 written as the shortest decimal of its float64 value, so any
    parser reads back the same float32 bits."""
    def rows(tag, arr):
        return "\n".join(f"{tag} " + " ".join(repr(float(x)) for x in r)
                         for r in arr.reshape(-1, arr.shape[-1]))

    n = mesh.num_triangles
    faces = "\n".join(f"f {3*t+1}/{3*t+1}/{3*t+1} {3*t+2}/{3*t+2}/{3*t+2} "
                      f"{3*t+3}/{3*t+3}/{3*t+3}" for t in range(n))
    with open(path, "w") as f:
        f.write("\n".join([rows("v", mesh.positions), rows("vt", mesh.uvs),
                           rows("vn", mesh.normals), faces, ""]))


def run_aux_path(rt, smi, out_dir) -> float:
    """The host-side modules of the port on the card: ``device_healthcheck``;
    ``probe_kernel`` around a K1 ``render_hits`` at config 2 (bit for bit
    against ``.cpu()`` of the same call); the config-2 terrain written as an
    OBJ and read by the C++ parser (``load_obj(backend="native")``) and the
    Python one, bit for bit; the CLI's ``--gizmo --gizmo-tris --shadows``
    render of that OBJ at 512x512 on the card against ``draw_aabbs`` applied
    here to the CLI's frame without gizmos, pixel for pixel.  Emits
    ``aux_path`` and returns config 2's hit share (the bench's ``hit_frac``)."""
    from unitysimpleraytracing_tpu_torch import cli, native
    from unitysimpleraytracing_tpu_torch.io.png import read_png
    from unitysimpleraytracing_tpu_torch.ops import trace_bvh4
    from unitysimpleraytracing_tpu_torch.utils import debug, resilience, visualize

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    healthy = resilience.device_healthcheck(device="cuda")
    health_s = time.perf_counter() - t0
    assert healthy is True, "device_healthcheck on the card is not True"

    # probe_kernel around K1 at config 2 (the default tree).
    scene = rt.build_scene(rt.terrain_mesh(res=182, size=80.0, amplitude=9.0, seed=0))
    bvh = rt.build_bvh(scene)
    cam = rt.make_camera(eye=(55.0, 45.0, 70.0), target=(0.0, 0.0, 0.0),
                         width=512, height=512)
    before = trace_bvh4.traverse_bvh4.launches
    got = debug.probe_kernel(rt.render_hits, scene, bvh, cam)
    assert trace_bvh4.traverse_bvh4.launches - before == 1, "probe did not launch K1 once"
    want = rt.render_hits(scene, bvh, cam)
    for f in ("t", "tri", "u", "v"):
        g, w = getattr(got, f), getattr(want, f).cpu().numpy()
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype and g.tobytes() == w.tobytes(), \
            f"probe_kernel: {f} differs from .cpu() of the same call"
    hit_frac = float(want.hit.float().mean())
    del scene, bvh, got, want

    # The native OBJ parser against the Python one on the config-2 terrain.
    mesh = rt.terrain_mesh(res=182, size=80.0, amplitude=9.0, seed=0)
    obj = os.path.join(HERE, "build", "chip_smoke_terrain_65k.obj")
    os.makedirs(os.path.dirname(obj), exist_ok=True)
    write_obj(obj, mesh)
    t0 = time.perf_counter()
    built = native.available()
    build_s = time.perf_counter() - t0
    assert built, f"native library did not build: {native.build_error()}"
    t0 = time.perf_counter()
    m_native = rt.load_obj(obj, backend="native")
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    m_python = rt.load_obj(obj, backend="python")
    python_s = time.perf_counter() - t0
    for f in ("positions", "uvs", "normals"):
        a, b = getattr(m_native, f), getattr(m_python, f)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), \
            f"native vs python loader: {f}"
    assert m_native.positions.tobytes() == mesh.positions.tobytes(), "OBJ round trip"

    # The CLI's gizmo overlay against draw_aabbs over its plain frame.
    W = H = 512
    plain_png = os.path.join(out_dir, "aux_cli_plain_512.png")
    gizmo_png = os.path.join(out_dir, "aux_cli_gizmo_512.png")
    common = ["--shadows", "--width", str(W), "--height", str(H)]
    before = trace_bvh4.traverse_bvh4.launches
    t0 = time.perf_counter()
    cli.main([obj, gizmo_png, "--gizmo", "--gizmo-tris", *common])
    cli_s = time.perf_counter() - t0
    cli.main([obj, plain_png, *common])
    cli_launches = trace_bvh4.traverse_bvh4.launches - before
    assert cli_launches == 4, f"two CLI frames with shadows launched K1 {cli_launches} times"
    # The CLI's scene, tree and camera, built again the way it builds them.
    lmesh = rt.load_obj(obj)
    lscene = rt.build_scene(lmesh)
    lbvh = rt.build_bvh(lscene)
    lo, hi = lmesh.positions.min(axis=(0, 1)), lmesh.positions.max(axis=(0, 1))
    center = (lo + hi) / 2
    eye = center + np.array([0.8, 0.6, 1.2]) * float(np.linalg.norm(hi - lo))
    lcam = rt.make_camera(eye=eye, target=center, width=W, height=H)
    frame = read_png(plain_png)[::-1].astype(np.float32) / 255.0
    over = visualize.draw_aabbs(frame, lcam, lscene.aabb_min[:lscene.count],
                                lscene.aabb_max[:lscene.count], color=(1.0, 1.0, 1.0))
    over = visualize.draw_aabbs(over, lcam, lbvh.node_aabb_min[:lbvh.num_internal],
                                lbvh.node_aabb_max[:lbvh.num_internal], color=(1.0, 0.0, 0.0))
    want_png = (np.clip(over[::-1], 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    got_png = read_png(gizmo_png)
    assert got_png.shape == want_png.shape == (H, W, 4)
    differ = int(np.count_nonzero((got_png != want_png).any(axis=-1)))
    assert differ == 0, f"CLI gizmo PNG differs from the overlay of its plain frame at {differ} px"
    rgb = got_png[..., :3].reshape(-1, 3)
    red = int(np.count_nonzero((rgb == (255, 0, 0)).all(axis=1)))
    white = int(np.count_nonzero((rgb == (255, 255, 255)).all(axis=1)))
    assert red > 0 and white > 0, (red, white)
    emit("aux_path", seconds=time.perf_counter() - t_phase,
         healthcheck={"healthy": healthy, "seconds": health_s},
         probe_kernel={"k1_launches": 1, "bit_identical_to_cpu_copy": True,
                       "hit_fraction_config2": hit_frac},
         native={"library": os.path.relpath(native.library_path(), HERE),
                 "compiler": native.compiler(),
                 "build_seconds": build_s, "triangles": m_native.num_triangles,
                 "native_load_s": native_s, "python_load_s": python_s,
                 "bit_identical_to_python": True},
         cli_gizmo={"png": gizmo_png, "k1_launches_two_frames": cli_launches,
                    "pixels_differing_from_overlay": differ, "red_px": red, "white_px": white,
                    "gizmo_run_seconds": cli_s},
         nvidia_smi=smi)
    return hit_frac


def run_bench(smi, hit_frac: float) -> dict:
    """The port's bench entry point once, in its own process, and its line
    checked: every documented key present and no TPU-only one, ``vs_baseline``
    null, every ms > 0, every bound fraction <= 1.05, no sort above the
    card's byte ceiling, its kernels launched, and ``hit_frac`` equal to the
    K1 frame's hit share at config 2 (``aux_path``).  Emits ``bench`` with
    the line."""
    from unitysimpleraytracing_tpu_torch.benchmarks import bench

    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "unitysimpleraytracing_tpu_torch.benchmarks.bench"],
        cwd=HERE, capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"bench exited {res.returncode}:\n{res.stderr[-4000:]}")
    line = json.loads(res.stdout.strip().splitlines()[-1])
    extra = line["extra"]
    assert line["metric"] == "traversal_mrays_per_s_per_chip" and line["unit"] == "Mrays/s"
    assert line["vs_baseline"] is None
    assert np.isfinite(line["value"]) and line["value"] > 0
    missing = sorted(set(bench.EXTRA_KEYS) - set(extra))
    assert not missing, f"bench keys missing: {missing}"
    assert not set(bench.TPU_ONLY_KEYS) & set(extra)

    def numbers(d, prefix=""):
        for k, v in d.items():
            if isinstance(v, dict):
                yield from numbers(v, f"{prefix}{k}.")
            elif isinstance(v, (int, float)) and not isinstance(v, bool):
                yield prefix + k, v

    flat = dict(numbers(extra))
    for k, v in flat.items():
        assert np.isfinite(v), (k, v)
        if "_ms" in k:  # lbvh_build_ms, bvh4_kernel_ms, sponza_class.frame_ms_min, ...
            assert v > 0, (k, v)
        if k.endswith("_fraction"):
            assert v <= 1.05, (k, v)
    for eng in bench.SORT_ENGINES:
        assert 0 < extra[f"sort_gkeys_{eng}"] <= extra["sort_gkeys_ceiling"], eng
    assert all(n > 0 for n in extra["kernel_launches"].values()), extra["kernel_launches"]
    assert extra["hit_frac"] == hit_frac, (extra["hit_frac"], hit_frac)
    emit("bench", seconds=seconds, nvidia_smi=smi, line=line)
    return line


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(HERE, "build", "chip_smoke"),
                    help="directory for the rendered PNG")
    ap.add_argument("--profile", action="store_true",
                    help="add the A/B of the texel gather's forms (for a profile of a "
                         "frame, a build or a load: python3 rtbench/run.py --trace 1)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this script runs on the card only",
              file=sys.stderr)
        return 1
    t_script = time.perf_counter()

    import unitysimpleraytracing_tpu_torch as rt
    from unitysimpleraytracing_tpu_torch.benchmarks import kernel_probe
    from unitysimpleraytracing_tpu_torch.core.camera import generate_rays
    from unitysimpleraytracing_tpu_torch.io.png import read_png, write_png
    from unitysimpleraytracing_tpu_torch.ops import (
        dispatch, lbvh, refit_bvh4, scan, sort, sort_radix_cuda, trace, trace_bvh2, trace_bvh4,
        unique,
    )
    from unitysimpleraytracing_tpu_torch.pipeline import render
    from unitysimpleraytracing_tpu_torch.utils import kernel_build, parity

    out_dir = os.path.abspath(args.out)
    os.makedirs(out_dir, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False

    # ---- 1. device ------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    timer = Timer()

    # ---- 2. build_kernels ------------------------------------------------
    t0 = time.perf_counter()
    kernel_names = (trace_bvh4.KERNEL_NAME, trace_bvh2.KERNEL_NAME,
                    sort_radix_cuda.KERNEL_NAME, scan.KERNEL_NAME, kernel_probe.KERNEL_NAME,
                    refit_bvh4.KERNEL_NAME)
    started = {name: kernel_build.start_build(name) for name in kernel_names}
    for name, st in started.items():
        kernel_build.finish_build(name, st)
    trace_bvh4._load_kernel()
    trace_bvh2._load_kernel()
    sort_radix_cuda._load_kernel()
    scan._load_kernel()
    kernel_probe._load_kernel()
    refit_bvh4._load_kernel("refit_launch")
    refit_bvh4._load_kernel("records_launch")
    emit("build_kernels", seconds=time.perf_counter() - t0,
         libraries={n: os.path.relpath(kernel_build.library_path(n), HERE)
                    for n in kernel_names},
         ptxas={
             n: [ln for ln in kernel_build.build_log(n).splitlines()
                 if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
             for n in kernel_names})

    # ---- 3. kernel_vs_plain / kernel2_vs_plain at the 65K / 512x512 shapes
    s65 = SimpleNamespace()
    s65.scene = rt.build_scene(rt.terrain_mesh(res=182, size=80.0, amplitude=9.0, seed=0))
    s65.bvh = rt.build_bvh(s65.scene, builder="karras")
    s65.cam = rt.make_camera(eye=(55.0, 45.0, 70.0), target=(0.0, 0.0, 0.0),
                             width=512, height=512)
    o, d = generate_rays(s65.cam)
    s65.o = dispatch._tile_major(o, 512, 512, 32).contiguous()
    s65.d = dispatch._tile_major(d, 512, 512, 32).contiguous()
    s65.soup = rt.build_scene(rt.random_triangle_soup(65536, seed=0))
    s65.soup_bvh = rt.build_bvh(s65.soup, builder="karras")
    s65.ro, s65.rd = random_rays(65536, seed=1, bound=60.0)
    tolerance = ("hit masks identical; t,u,v bit-identical where tri agrees; tri differs "
                 "only at exact-t ties (4e-6 relative)")

    cases, first4 = kernel_cases_65k(
        rt, timer, trace_bvh4, trace_bvh4.prepare_tables4(s65.scene, s65.bvh),
        trace_bvh4.prepare_tables4(s65.soup, s65.soup_bvh), s65)
    emit("kernel_vs_plain", tolerance=tolerance, cases=cases)

    cases, first2 = kernel_cases_65k(
        rt, timer, trace_bvh2, trace_bvh2.prepare_tables(s65.scene, s65.bvh),
        trace_bvh2.prepare_tables(s65.soup, s65.soup_bvh), s65)
    # The binary-record kernel against the BVH4 kernel on case a, under the
    # parity contract: both difference the same vertices with the same IEEE
    # subtraction (one in the traversal, one at pack time), so t, u, v should
    # agree bit for bit wherever the winning triangle agrees.
    g2, g4 = np_hits(first2), np_hits(first4)
    st24 = parity.assert_hit_parity(g2, g4)
    same_tri = (g2.tri == g4.tri) & (g4.t != MAX_FLOAT)
    st24["tuv_bit_differences_where_tri_agrees"] = int(sum(
        np.count_nonzero(getattr(g2, f).view(np.uint32)[same_tri]
                         != getattr(g4, f).view(np.uint32)[same_tri])
        for f in ("t", "u", "v")))
    emit("kernel2_vs_plain", tolerance=tolerance, cases=cases,
         cuda2_vs_cuda4_case_a=st24, nvidia_smi=smi)
    del first2, first4, g2, g4

    # ---- 3b. parity_scale: K1, K2, K1c against the JAX package at config 2
    run_parity_scale(rt, smi)

    # ---- 3c. parity_frame: the shadowed and the animated frame against JAX
    run_parity_frame(rt, smi, out_dir)

    # ---- 3d. parity_large: the 1M tree and the chunked scenes against JAX
    run_parity_large(rt, smi, out_dir)

    # The shared-stack packet engine against the per-ray oracle: a 64x64
    # frame of the same scene, 4 packets of 1024 rays in lockstep.  A host
    # loop of eager launches; its time is written down, not judged.
    cam64 = rt.make_camera(eye=(55.0, 45.0, 70.0), target=(0.0, 0.0, 0.0),
                           width=64, height=64)
    po, pd = generate_rays(cam64)
    po = dispatch._tile_major(po, 64, 64, 32).contiguous()
    pd = dispatch._tile_major(pd, 64, 64, 32).contiguous()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = dispatch.trace_rays(s65.scene, s65.bvh, po, pd, impl="packet")
    torch.cuda.synchronize()
    packet_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    want = dispatch.trace_rays(s65.scene, s65.bvh, po, pd, impl="perray")
    torch.cuda.synchronize()
    perray_ms = (time.perf_counter() - t0) * 1e3
    for f in ("t", "tri", "u", "v"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f"packet vs perray: {f}"
    packet_check = {"rays": int(po.shape[0]), "packets": int(po.shape[0]) // dispatch.PACKET,
                    "hits": int(got.hit.sum()), "bit_identical_to_perray": True,
                    "packet_ms_host_clock": packet_ms, "perray_ms_host_clock": perray_ms}
    del s65, got, want, po, pd

    # ---- 4. main_path: 260,642 triangles, 1920x1056, shadows ------------
    W, H = 1920, 1056
    tex_rgba = (0.8, 0.7, 0.6, 1.0)
    bg = np.asarray([0.1, 0.1, 0.12], np.float32)
    png_path = os.path.join(out_dir, "chip_smoke_260k_1920x1056.png")

    trace_bvh4.traverse_bvh4.launches = 0
    mesh = rt.terrain_mesh(res=362, size=160.0, amplitude=20.0, seed=1)
    scene = rt.build_scene(mesh)
    bvh = rt.build_bvh(scene, builder="karras")
    cam = rt.make_camera(eye=(110.0, 90.0, 140.0), target=(0.0, 0.0, 0.0),
                         width=W, height=H)
    tex = rt.solid_texture(tex_rgba)
    frame = rt.render_frame(scene, bvh, cam, tex, bg, shadows=True)
    image = rt.frame_to_image(frame)
    main_image = image
    write_png(png_path, image)
    torch.cuda.synchronize()
    main_launches = trace_bvh4.traverse_bvh4.launches
    assert main_launches == 2, f"main path launched the kernel {main_launches} times, not 2"
    assert mesh.num_triangles == 260642, mesh.num_triangles

    assert image.shape == (H, W, 4) and np.isfinite(image).all(), "frame not finite"
    assert read_png(png_path).shape == (H, W, 4)
    hits = rt.render_hits(scene, bvh, cam)
    rgba = rt.render_rgba(scene, bvh, cam, tex, shadows=True)
    hit_mask = hits.hit.reshape(H, W)
    assert torch.equal(rgba[..., 3] == 1.0, hit_mask), "alpha is not the hit mask"
    assert bool(((rgba[..., 3] == 0.0) | (rgba[..., 3] == 1.0)).all())
    hit_fraction = float(hit_mask.float().mean())
    assert 0.05 < hit_fraction < 0.95, f"hit fraction {hit_fraction} out of band"
    # Composition: miss pixels show the background exactly.
    miss_rgb = frame[..., :3][~hit_mask]
    assert torch.equal(miss_rgb, torch.from_numpy(bg).cuda().expand_as(miss_rgb))

    # Stage times (CUDA events, median of 5 after a warm-up).
    table = trace_bvh4.prepare_tables4(scene, bvh)
    before = trace_bvh4.traverse_bvh4.launches
    frame_ms = timer.median_ms(
        lambda: rt.render_frame(scene, bvh, cam, tex, bg, shadows=True), iters=5)
    assert trace_bvh4.traverse_bvh4.launches - before == 2 * 6, "not 2 launches per frame"
    frame_noshadow_ms = timer.median_ms(
        lambda: rt.render_frame(scene, bvh, cam, tex, bg), iters=5)

    t0 = time.perf_counter()
    rt.build_scene(mesh)
    torch.cuda.synchronize()
    ingest_ms = (time.perf_counter() - t0) * 1e3
    keys, sorted_tri = sort.sort_key_val(scene.morton, scene.tri_index)
    ukeys = unique.distribute_keys(keys, scene.count)
    topo = lbvh.build_topology(ukeys, scene.count, with_parents=False)
    stages = {
        "ingest_host_to_device": ingest_ms,
        "build": timer.median_ms(lambda: rt.build_bvh(scene, builder="karras")),
        "build_sort": timer.median_ms(
            lambda: sort.sort_key_val(scene.morton, scene.tri_index)),
        "build_distribute_keys": timer.median_ms(
            lambda: unique.distribute_keys(keys, scene.count)),
        "build_topology": timer.median_ms(
            lambda: lbvh.build_topology(ukeys, scene.count, with_parents=False)),
        "build_refit": timer.median_ms(
            lambda: lbvh.refit(topo[6], topo[7], sorted_tri, scene.aabb_min,
                               scene.aabb_max, scene.count)),
        # A fresh Bvh each time, so the pack pays the depth chase, the plan
        # and the gathers (no cache).
        "table_pack": timer.median_ms(
            lambda: trace_bvh4.prepare_tables4(scene, bvh.replace(left=bvh.left.clone())),
            iters=3),
        "primary_trace": timer.median_ms(
            lambda: dispatch.camera_trace(scene, bvh, cam, impl="cuda4", tables=table)),
        "shadow_trace": timer.median_ms(
            lambda: render._shadow_mask(scene, bvh, hits, "cuda4", cam, table)),
    }
    shadow = render._shadow_mask(scene, bvh, hits, "cuda4", cam, table)
    bg_dev = torch.from_numpy(bg).cuda().expand(H, W, 3)
    stages["shade_compose"] = timer.median_ms(
        lambda: trace.compose(
            bg_dev, trace.shade(scene, tex, hits, shadow=shadow).reshape(H, W, 4)))
    stages["frame_with_shadows"] = frame_ms
    stages["frame_without_shadows"] = frame_noshadow_ms
    n_rays = W * H
    records_260k = int(table.shape[0])
    emit("main_path", triangles=mesh.num_triangles, width=W, height=H,
         primary_rays=n_rays, shadow_rays=n_rays, records=int(table.shape[0]),
         table_mb=table.numel() * 4 / 2**20, kernel_launches=main_launches,
         launches_per_frame=2, hit_fraction=hit_fraction,
         shadowed_fraction=float(shadow.float().mean()), png=png_path,
         stage_ms=stages, mrays_per_s=2 * n_rays / frame_ms / 1e3, nvidia_smi=smi)

    # The kernels at the main path's shapes, over the Karras tree of the frame
    # above and over the default tree that users trace (``build_bvh(scene)``):
    # each against its plain version, timed alone, with the work this run's
    # data needs.
    t0 = time.perf_counter()
    on_tree, rays_of, tables_of = {}, {}, {}
    default_tree = rt.build_bvh(scene)
    for label, tree in (("default", default_tree), ("karras", bvh)):
        rays_of[label] = frame_rays(rt, scene, tree, cam, W, H)
        tables_of[label] = (trace_bvh4.prepare_tables4(scene, tree),
                            trace_bvh2.prepare_tables(scene, tree))
        on_tree[label] = {
            "records": {"trace_bvh4": int(tables_of[label][0].shape[0]),
                        "trace_bvh2": int(tables_of[label][1].shape[0])},
            **{m.KERNEL_NAME: traversal_on_tree(timer, parity, m, t, rays_of[label], n_rays)
               for m, t in zip((trace_bvh4, trace_bvh2), tables_of[label])},
        }
    measure_s = time.perf_counter() - t0
    t4, t2 = tables_of["karras"]
    o, d, _ = rays_of["karras"]["primary"]

    def k1_primary():
        return trace_bvh4.traverse_bvh4(t4, o, d)

    def k2_primary():
        return trace_bvh2.traverse_bvh2(t2, o, d)

    # The two kernels in turns on the same primary rays, cold L2.
    turns = [[name, timer.median_ms(fn, iters=7, cold=True, queued=True)]
             for name, fn in (("trace_bvh4", k1_primary), ("trace_bvh2", k2_primary),
                              ("trace_bvh2", k2_primary), ("trace_bvh4", k1_primary))]
    emit("kernel_at_main_path_shapes", trees=on_tree, seconds=measure_s,
         karras_primary_ms_in_turns_cold_l2=turns,
         bvh2_over_bvh4=(turns[1][1] + turns[2][1]) / (turns[0][1] + turns[3][1]),
         tolerance="t, u, v bit-identical where tri agrees, tri only at exact-t ties, "
                   "steps identical",
         timing="CUDA events, median of 7 after a warm-up, the device held while the host "
                "enqueues; plain versions one run",
         nvidia_smi=smi)
    # ---- 4b. K1c: the compressed-record variant on the default tree -------
    k1c_launches, k1c = run_compressed_records(
        rt, timer, parity, scene, default_tree, rays_of["default"],
        tables_of["default"][0], n_rays)
    emit("compressed_records", triangles=mesh.num_triangles, nvidia_smi=smi, **k1c)
    del t4, t2, tables_of, rays_of, o, d, default_tree
    if args.profile:
        # Forms of one 2 M-row gather of 16-byte texel rows (why
        # sample_bilinear gathers the way it does), in turns within this call.
        flat = tex.data.reshape(-1, 4)
        idx = torch.randint(0, flat.shape[0], (n_rays,), device="cuda")
        cols = torch.arange(4, device="cuda")
        forms = {
            "advanced_indexing": lambda: flat[idx],
            "index_select": lambda: flat.index_select(0, idx),
            "gather_expanded_index": lambda: torch.gather(
                flat, 0, idx[:, None].expand(-1, 4)),
            "flat_elements": lambda: flat.reshape(-1)[idx[:, None] * 4 + cols],
        }
        order = list(forms) + list(forms)[::-1]
        want_rows = forms["advanced_indexing"]()
        emit("gather_form_ab", rows=n_rays, row_bytes=16, nvidia_smi=smi,
             ms_in_turns=[[k, timer.median_ms(forms[k])] for k in order],
             same_values=all(bool(torch.equal(f(), want_rows)) for f in forms.values()))
    # ---- 4c. dynamic_path: batched frames and the animated renderer --------
    dyn_launches, dynamic = run_dynamic_path(
        rt, timer, scene, bvh, cam, tex, bg, W, H, main_image)
    emit("dynamic_path", triangles=mesh.num_triangles, width=W, height=H,
         packet_vs_perray_65k_64x64=packet_check, nvidia_smi=smi, **dynamic)
    del scene, bvh, table, hits, rgba, frame, shadow

    # ---- 5. main_path_1m: 1,048,352 triangles, one tree, 512x512 --------
    mesh = rt.terrain_mesh(res=725, size=300.0, amplitude=30.0, seed=0)
    assert mesh.num_triangles == 1048352, mesh.num_triangles
    before = trace_bvh4.traverse_bvh4.launches
    t0 = time.perf_counter()
    scene = rt.build_scene(mesh)
    bvh = rt.build_bvh(scene, builder="karras")
    cam = rt.make_camera(eye=(210.0, 170.0, 260.0), target=(0.0, 0.0, 0.0),
                         width=512, height=512)
    frame = rt.render_frame(scene, bvh, cam, tex, bg)
    torch.cuda.synchronize()
    first_frame_s = time.perf_counter() - t0
    assert trace_bvh4.traverse_bvh4.launches - before == 1
    assert bool(torch.isfinite(frame).all()) and tuple(frame.shape) == (512, 512, 4)
    frame_1m_ms = timer.median_ms(
        lambda: rt.render_frame(scene, bvh, cam, tex, bg), iters=3)
    build_1m_ms = timer.median_ms(lambda: rt.build_bvh(scene, builder="karras"), iters=3)
    torch.cuda.reset_peak_memory_stats()
    rt.build_bvh(scene, builder="karras")
    build_peak_gb = torch.cuda.max_memory_allocated() / 2**30
    table = trace_bvh4.prepare_tables4(scene, bvh)
    o, d = generate_rays(cam)
    pick = torch.linspace(0, 512 * 512 - 1, 4096, device="cuda").long()
    oo, dd = o[pick].contiguous(), d[pick].contiguous()
    ref = dispatch.trace_rays(scene, bvh, oo, dd, impl="perray")
    got = dispatch.trace_rays(scene, bvh, oo, dd, impl="cuda4")
    oracle = parity.assert_hit_parity(np_hits(got), np_hits(ref), uv_atol=1e-5)
    vs_plain_1m, _, _, _ = compare_kernel_with_plain(
        "trace_bvh4: 4,096 camera rays over 1,048,352 triangles", trace_bvh4, parity,
        table, oo, dd)
    hits_1m = rt.render_hits(scene, bvh, cam)
    emit("main_path_1m", triangles=mesh.num_triangles, width=512, height=512,
         records=int(table.shape[0]), table_mb=table.numel() * 4 / 2**20,
         first_frame_seconds_with_ingest_build_pack=first_frame_s,
         frame_ms=frame_1m_ms, build_ms=build_1m_ms, build_peak_gb=build_peak_gb,
         hit_fraction=float(hits_1m.hit.float().mean()),
         oracle_check_vs_perray_bvh2=oracle, kernel_vs_plain_4096_rays=vs_plain_1m,
         nvidia_smi=smi)
    del scene, bvh, table, frame, o, d, hits_1m

    # ---- 6. golden: frames rendered on the card through the kernel -------
    before = trace_bvh4.traverse_bvh4.launches
    sol = rt.solid_texture((0.9, 0.6, 0.3, 1.0))
    goldens = {}
    scene = rt.build_scene(rt.cube_mesh(size=2.0))
    bvh = rt.build_bvh(scene, builder="karras")
    cam = rt.make_camera(eye=(3, 2.5, 4), target=(0, 0, 0), width=128, height=96)
    f = rt.render_frame(scene, bvh, cam, sol, np.asarray([0.1, 0.1, 0.12], np.float32))
    goldens["cube_128x96.png"] = parity.compare_images(
        parity.frame_to_uint8(rt.frame_to_image(f)),
        read_png(os.path.join(GOLDEN_DIR, "cube_128x96.png")), "cube_128x96.png")
    scene = rt.build_scene(rt.terrain_mesh(res=48, size=40.0, amplitude=6.0, seed=0))
    bvh = rt.build_bvh(scene, builder="karras")
    cam = rt.make_camera(eye=(30, 25, 38), target=(0, 0, 0), width=128, height=96)
    f = rt.render_frame(scene, bvh, cam, sol, np.asarray([0.05, 0.05, 0.08], np.float32),
                        shadows=True)
    goldens["terrain_shadow_128x96.png"] = parity.compare_images(
        parity.frame_to_uint8(rt.frame_to_image(f)),
        read_png(os.path.join(GOLDEN_DIR, "terrain_shadow_128x96.png")),
        "terrain_shadow_128x96.png")
    assert trace_bvh4.traverse_bvh4.launches - before == 3
    emit("golden", tolerance="more than 2/255 off on fewer than 0.2% of values",
         fraction_off=goldens)

    # ---- 7. the build's radix-sort path (kernels K3, K4, K5) -------------
    del scene, bvh, cam, f
    sort_entries = run_sort_slice(rt, timer, smi, main_image, tex, bg, W, H)

    # ---- 8. the measurement path (probe kernels P1, P2) --------------------
    probe_entries = run_probe_slice(smi, timer)

    # ---- 9. the default build (SAH builders) at full width ------------------
    run_sah_path(rt, timer, smi, tex, bg, W, H)

    # ---- 9b. large scenes: chunked build, trace and frames ------------------
    run_chunked_path(rt, timer, smi, tex, bg, W, H, out_dir)

    # ---- 9c. the multi-device path: parallel/dist, multihost, pipeline_pp ----
    from unitysimpleraytracing_tpu_torch.benchmarks import dist_path

    t0 = time.perf_counter()
    dist_fields = dist_path.run()
    emit("dist_path", seconds=time.perf_counter() - t0, nvidia_smi=smi, **dist_fields)

    # ---- 9d. the host-side modules, and the bench entry point ----------------
    hit_frac_config2 = run_aux_path(rt, smi, out_dir)
    run_bench(smi, hit_frac_config2)

    # ---- 10. kernels ------------------------------------------------------
    print(smi, flush=True)
    print(json.dumps({"kernels": [
        traversal_entry(on_tree, "trace_bvh4", "ops/trace_pallas4.py:366",
                        "ops/trace_pallas4.py::_make_kernel4", main_launches, 64, n_rays),
        traversal_entry(on_tree, "trace_bvh2", "ops/trace_pallas.py:272",
                        "ops/trace_pallas.py::_make_kernel", dyn_launches["trace_bvh2"], 32,
                        n_rays),
        compressed_entry(k1c, k1c_launches, n_rays),
        *sort_entries, *probe_entries]}), flush=True)
    emit("done", seconds=time.perf_counter() - t_script)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
