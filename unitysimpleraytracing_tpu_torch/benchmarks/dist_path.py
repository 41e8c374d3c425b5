"""The multi-device path (``parallel/dist``, ``multihost``, ``pipeline_pp``)
driven on one card and held to the single-tree trace.

    python -m unitysimpleraytracing_tpu_torch.benchmarks.dist_path

It runs on the card only (the CPU tests of the same layer are
``tests/test_torch_dist.py``).  `chip_smoke.py` runs it as its ``dist_path``
phase; alone it prints the same JSON object.  Steps:

1. World size 1 in this process: ``make_mesh(1, 1)`` starts a one-process
   NCCL group (gloo on the CPU).  BASELINE config 5's scene (the
   999,698-triangle terrain of ``benchmarks/scaling.py``) and its ray
   generator at 4,096 and 1,048,576 rays; `render_hits_dp`, `_sharded`,
   `_ring` and `_shuffle` held to ``trace_rays`` (K1) over a Karras tree of
   the whole scene, each timed beside that one trace; K1 launches, host
   reads and synchronising calls of each engine call.  At 4,096 rays K1 is
   held to its plain version on the path's own inputs: the whole-scene
   trace bit for bit to ``impl="plain4"``, the engines to that plain trace,
   and each engine with ``impl="plain4"`` bit for bit to itself with K1 (the
   shard's own tree, the ring's ``t_init`` and guaranteed-miss rays).
2. Config 5 on the one card: 8 processes (spawned after the parent
   has built the kernels) in one gloo group, every tensor on ``cuda:0``
   (NCCL refuses two ranks on one GPU); ``make_host_mesh()`` with
   ``LOCAL_WORLD_SIZE=4`` gives (dp, tp) = (2, 4).  `render_hits_sharded`,
   `_ring`, `_shuffle` on a count and on an area partition, and
   `render_hits_dp` at (8, 1); every rank's rows come back to this process
   and are held to step 1's single-tree trace bit for bit (t everywhere;
   tri, u, v, uv, normal on hits, the last two against step 1's world-1
   engines); at 4,096 rays to the plain trace, and every case on every rank
   with ``impl="plain4"`` bit for bit to itself with K1 (the 250K-triangle
   shard trees, four ring hops).  Per rank: K1 launches.  The shuffle's
   ``exchange_fraction``:
   copies sent / (R x tp).  Times are of 8 processes sharing one card over
   gloo: not scaling.
3. `render_frames_pipelined` on ranks 0 and 1 of that group: the
   260,642-triangle terrain, the four deformations of chip_smoke.py's dynamic
   path, the 1920x1056 frame's primary rays; held bit for bit to a serial
   deform → ``build_bvh(builder="karras")`` → ``trace_rays`` of each frame,
   frame 0 of the pipelined stream also bit for bit to ``impl="plain4"``;
   timed per frame beside that serial loop (one card cannot overlap the
   stages' work the way two cards would).
4. ``multihost``: ``initialize`` over ``tcp://127.0.0.1:<free port>`` for the
   group of step 2; the host mesh's tp rows each within one "host" of 4
   ranks; the per-host ingest of config 5 (each host builds half the mesh
   against the fixed parity box) gathered across hosts equals the full
   ingest bit for bit.

Every collective of the group times out after 120 s and every worker after
``limit_s``; a failed worker fails the run.
"""
from __future__ import annotations

import faulthandler
import hashlib
import json
import os
import socket
import statistics
import sys
import time
import traceback
import warnings
from datetime import timedelta

import numpy as np
import torch

SIZES = {"res": 708, "rays": (4096, 1 << 20), "pp_res": 362, "pp_w": 1920, "pp_h": 1056,
         "iters": 3}
PLAIN_AT = 4096    # the ray count at which K1 is also held to its plain version
PAYLOAD = ("t", "tri", "u", "v", "uv", "normal")
WORLD = 8          # the gloo group of steps 2-4: (dp, tp) = (2, 4) at 4 ranks a "host"
LIMIT_S = 300.0    # a worker's wall-clock limit


def config5_scene(res: int, device):
    """``benchmarks/scaling.py``'s terrain (res 708: 999,698 triangles)."""
    import unitysimpleraytracing_tpu_torch as pt

    return pt.build_scene(pt.terrain_mesh(res=res, size=80.0, amplitude=9.0, seed=0),
                          device=device)


def config5_rays(n: int, device):
    """``benchmarks/scaling.py:97-103``: origins above the terrain, looking
    down and around; a fresh ``default_rng(0)`` for each batch."""
    rng = np.random.default_rng(0)
    o = rng.uniform(-40, 40, size=(n, 3)).astype(np.float32)
    o[:, 1] = 50.0
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 1] = -np.abs(d[:, 1]) - 0.3
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o).to(device), torch.from_numpy(d).to(device)


def deformed_frames(scene, phases=(0.3, 1.1, 1.9, 2.7)) -> torch.Tensor:
    """chip_smoke.py's dynamic-path deformations: (F, capacity, 3, 3)."""
    t = scene.triangles
    base = torch.stack([t.a, t.b, t.c], dim=1)
    out = base[None].repeat(len(phases), 1, 1, 1)
    for i, ph in enumerate(phases):
        out[i, ..., 1] += 0.4 * torch.sin(base[..., 0] * 0.5 + ph)
    return out


def _ms(fn, iters: int) -> list[float]:
    """Host-clock ms of ``iters`` calls, each ending in a synchronise, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def synchronising_calls(fn) -> int:
    """Synchronising calls in one call of ``fn`` (`torch.cuda`'s sync debug
    mode)."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def _fields(out) -> dict:
    if hasattr(out, "t"):
        return {f: getattr(out, f) for f in ("t", "tri", "u", "v")}
    return dict(zip(PAYLOAD, out))


def _rows(mask: np.ndarray, a: dict, b: dict, limit: int = 8) -> list[dict]:
    """The first ``limit`` rows of ``mask``: ray, t's bits, tri of a and b."""
    return [{"ray": int(i), "t_bits": f"{int(a['t'][i:i + 1].view(np.uint32)[0]):08x}",
             "tri": [int(a["tri"][i]), int(b["tri"][i])]}
            for i in np.flatnonzero(mask)[:limit]]


def hold(got: dict, ref, extra: dict | None = None) -> dict:
    """``got`` (numpy fields) against the single-tree trace ``ref``: t bit for
    bit everywhere; tri, u, v on hits under the parity contract with
    ``exact=True`` (bits equal where tri agrees, tri differs only at exact-t
    ties, listed in ``tie_rows``); uv and normal bit for bit against
    ``extra`` where given, on the hits where the two agree on the triangle.
    The hits where they do not are exact-t ties too (t's bits equal, asserted,
    listed in ``payload_tie_rows``): a ray that meets two triangles at the
    same t may take either, and each carries its own triangle's uv."""
    from types import SimpleNamespace

    from unitysimpleraytracing_tpu_torch.utils import parity

    want = {f: getattr(ref, f).cpu().numpy() for f in ("t", "tri", "u", "v")}
    parity.assert_bits_equal(got["t"], want["t"], "t")
    hit = want["t"] != parity.MAX_FLOAT
    # a miss carries shard-local triangle 0: tri is compared on hits only
    tri = np.where(hit, got["tri"], want["tri"])
    stats = parity.assert_hit_parity(
        SimpleNamespace(t=got["t"], tri=tri, u=got["u"], v=got["v"]),
        SimpleNamespace(**want), exact=True)
    stats["tie_rows"] = _rows(hit & (got["tri"] != want["tri"]), got, want)
    if extra is not None:
        tie = hit & (got["tri"] != extra["tri"])
        parity.assert_bits_equal(got["t"][tie], extra["t"][tie], "t where tri differs")
        same = hit & ~tie
        for f in ("uv", "normal"):
            parity.assert_bits_equal(got[f][same], extra[f][same], f)
        stats["payload_compared"] = int(same.sum())
        stats["payload_tie_rows"] = _rows(tie, got, extra)
    return stats


def bit_identical(got: dict, want: dict, what: str) -> bool:
    """Every field of ``got`` bit for bit equal to ``want``'s (tensors); raises
    where one differs."""
    from unitysimpleraytracing_tpu_torch.utils import parity

    for f, x in got.items():
        parity.assert_bits_equal(x.cpu().numpy(), want[f].cpu().numpy(), f"{what}: {f}")
    return True


# --------------------------------------------------------------------------
# Step 1: world size 1, in this process
# --------------------------------------------------------------------------


def world_one() -> tuple[dict, dict]:
    """Returns (the step's fields, {n_rays: (the single-tree hits the rows
    are held to, the world-1 all-gather engine's payload as numpy)} for
    step 2)."""
    import torch.distributed as tdist

    import unitysimpleraytracing_tpu_torch as pt
    from unitysimpleraytracing_tpu_torch.ops import dispatch, trace_bvh4
    from unitysimpleraytracing_tpu_torch.parallel import dist

    K1 = trace_bvh4.traverse_bvh4
    mesh = dist.make_mesh(1, 1, device="cuda")
    scene = config5_scene(SIZES["res"], mesh.device)
    bvh = pt.build_bvh(scene, builder="karras")
    ss = dist.partition_scene(scene, 1)
    engines = {
        "dp": lambda o, d, impl="auto": dist.render_hits_dp(scene, bvh, o, d, mesh, impl),
        "sharded": lambda o, d, impl="auto": dist.render_hits_sharded(ss, o, d, mesh, impl),
        "ring": lambda o, d, impl="auto": dist.render_hits_ring(ss, o, d, mesh, impl),
        "shuffle": lambda o, d, impl="auto": dist.render_hits_shuffle(ss, o, d, mesh, impl),
    }
    fields = {"backend": tdist.get_backend(), "triangles": int(scene.count), "by_rays": {}}
    refs = {}
    for n in SIZES["rays"]:
        o, d = config5_rays(n, mesh.device)
        ref = dispatch.trace_rays(scene, bvh, o, d)  # auto: K1
        row = {"hits": int(ref.hit.sum())}
        if n == PLAIN_AT:  # K1 held to its plain version; the rows to the plain trace
            plain = dispatch.trace_rays(scene, bvh, o, d, impl="plain4")
            row["single_trace_cuda4_bit_identical_to_plain4"] = bit_identical(
                _fields(ref), _fields(plain), "trace_rays cuda4 vs plain4")
            ref = plain
        kept = None
        for name, fn in engines.items():
            K1.launches, mesh.host_reads = 0, 0
            out = fn(o, d)
            torch.cuda.synchronize()
            launches, reads = K1.launches, mesh.host_reads
            tensors = _fields(out)
            for x in tensors.values():
                if x.device != mesh.device:
                    raise AssertionError(f"{name}: a result on {x.device}, not {mesh.device}")
            got = {k: v.cpu().numpy() for k, v in tensors.items()}
            row[name] = {"k1_launches": launches, "host_reads": reads,
                         "parity": hold(got, ref),
                         "syncs_per_call": synchronising_calls(lambda: fn(o, d))}
            if n == PLAIN_AT:
                row[name]["cuda4_bit_identical_to_plain4"] = bit_identical(
                    tensors, _fields(fn(o, d, "plain4")), f"{name} cuda4 vs plain4")
            if name == "sharded":
                kept = got
        base = _ms(lambda: dispatch.trace_rays(scene, bvh, o, d), SIZES["iters"])
        row["single_trace_ms"] = statistics.median(base)
        for name, fn in engines.items():
            ms = _ms(lambda: fn(o, d), SIZES["iters"])
            row[name]["ms"] = statistics.median(ms)
            row[name]["overhead_ms"] = row[name]["ms"] - row["single_trace_ms"]
        fields["by_rays"][str(n)] = row
        refs[n] = (ref, kept)
    return fields, refs


# --------------------------------------------------------------------------
# Steps 2-4: the workers
# --------------------------------------------------------------------------


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _digest(x: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(x).view(np.uint8)).hexdigest()[:16]


def worker(rank: int, world: int, port: int, limit_s: float, q) -> None:
    """One rank of steps 2-4 on ``cuda:0``; puts one dict on ``q`` and exits
    (non-zero on an error, after putting its traceback)."""
    faulthandler.dump_traceback_later(limit_s, exit=True)
    os.environ["LOCAL_WORLD_SIZE"] = "4"
    try:
        q.put(_work(rank, world, port, torch.device("cuda", 0)))
    except BaseException:
        q.put({"rank": rank, "error": traceback.format_exc()})
        raise


def _work(rank, world, port, dev) -> dict:
    import torch.distributed as tdist

    import unitysimpleraytracing_tpu_torch as pt
    from unitysimpleraytracing_tpu_torch.parallel import dist, multihost, pipeline_pp

    torch.cuda.set_device(dev)
    res = {"rank": rank}
    t0 = time.perf_counter()
    res["initialized"] = multihost.initialize(
        f"127.0.0.1:{port}", world, rank, backend="gloo", device=dev,
        timeout=timedelta(seconds=120))
    res["backend"] = tdist.get_backend()
    mesh = multihost.make_host_mesh(device=dev)
    res["host_mesh"] = {"shape": [mesh.shape["dp"], mesh.shape["tp"]],
                        "coords": [mesh.coords["dp"], mesh.coords["tp"]],
                        "tp_row": mesh.ranks["tp"]}

    # -- step 4: per-host ingest against the full ingest ----------------------
    terrain = pt.terrain_mesh(res=SIZES["res"], size=80.0, amplitude=9.0, seed=0)
    n_tri = terrain.num_triangles
    hosts = mesh.shape["dp"]
    lo, hi = multihost.host_shard_bounds(n_tri, hosts, mesh.coords["dp"])
    bound = pt.constants.PARITY_SCENE_BOUND
    local = pt.build_scene(pt.MeshData(positions=terrain.positions[lo:hi],
                                       uvs=terrain.uvs[lo:hi], normals=terrain.normals[lo:hi]),
                           scene_bound=bound, device=dev)
    full = pt.build_scene(terrain, scene_bound=bound, device=dev)
    m = hi - lo
    ingest = {}
    for f in ("morton", "aabb_min", "aabb_max"):
        want = getattr(full, f)[:n_tri]
        got = dist._all_gather(getattr(local, f)[:m], mesh, "dp").reshape(want.shape)
        ingest[f] = bool(torch.equal(_bits(got), _bits(want)))
    ingest["hosts"], ingest["triangles_per_host"] = hosts, m
    res["ingest_equals_full"] = ingest
    del local, full
    res["setup_s"] = time.perf_counter() - t0

    res["cases"] = _config5_cases(pt, dist, mesh, world, dev)

    # -- step 3: the pipeline on ranks 0 and 1 --------------------------------
    pp = pipeline_pp.make_pp_mesh(device=dev)
    if pp.coords["pp"] is not None:
        res["pipeline"] = _pipeline(pt, pipeline_pp, pp, dev)
    tdist.barrier()
    tdist.destroy_process_group()
    return res


def _config5_cases(pt, dist, mesh, world, dev) -> dict:
    """Step 2: config 5 on the (2, 4) host mesh and on (8, 1)."""
    import torch.distributed as tdist

    from unitysimpleraytracing_tpu_torch.ops import trace_bvh4

    K1 = trace_bvh4.traverse_bvh4
    scene = config5_scene(SIZES["res"], dev)
    bvh = pt.build_bvh(scene, builder="karras")
    tp = mesh.shape["tp"]
    parts = {"count": dist.partition_scene(scene, tp),
             "area": dist.partition_scene(scene, tp, balance="area")}
    mesh8 = dist.make_mesh(world, 1, device=dev)
    out = {}
    for n in SIZES["rays"]:
        o, d = config5_rays(n, dev)
        cases = {
            "sharded": (lambda impl: dist.render_hits_sharded(parts["count"], o, d, mesh, impl),
                        mesh, "dp"),
            "ring": (lambda impl: dist.render_hits_ring(parts["count"], o, d, mesh, impl),
                     mesh, ("dp", "tp")),
            "shuffle": (lambda impl: dist.render_hits_shuffle(parts["count"], o, d, mesh, impl),
                        mesh, ("dp", "tp")),
            "shuffle_area": (lambda impl: dist.render_hits_shuffle(parts["area"], o, d, mesh,
                                                                   impl), mesh, ("dp", "tp")),
            "dp_8x1": (lambda impl: dist.render_hits_dp(scene, bvh, o, d, mesh8, impl),
                       mesh8, "dp"),
        }
        for name, (fn, m_, layout) in cases.items():
            tdist.barrier()
            K1.launches, m_.host_reads, m_.copies_sent = 0, 0, 0
            got = _fields(fn("auto"))
            torch.cuda.synchronize()
            entry = {"k1_launches": K1.launches, "host_reads": m_.host_reads,
                     "copies_sent": m_.copies_sent,
                     "start": dist.ray_block(m_, n, layout).start}
            if n == PLAIN_AT:  # this rank's shard trees and hops, K1 against plain
                entry["cuda4_bit_identical_to_plain4"] = bit_identical(
                    got, _fields(fn("plain4")), f"rank {m_.rank} {name} cuda4 vs plain4")
            rows = {k: v.cpu().numpy() for k, v in got.items()}
            entry["digest"] = {k: _digest(v) for k, v in rows.items()}
            if layout != "dp" or m_.coords["tp"] == 0:  # a replicated block travels once
                entry["rows"] = rows
            times = []
            for _ in range(SIZES["iters"]):
                tdist.barrier()
                t1 = time.perf_counter()
                fn("auto")
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t1) * 1e3)
            entry["ms"] = times
            out[f"{name}@{n}"] = entry
    return out


def _pipeline(pt, pipeline_pp, pp, dev) -> dict:
    import torch.distributed as tdist

    from unitysimpleraytracing_tpu_torch.core.camera import generate_rays
    from unitysimpleraytracing_tpu_torch.ops import dispatch, trace_bvh4

    K1 = trace_bvh4.traverse_bvh4
    scene = pt.build_scene(pt.terrain_mesh(res=SIZES["pp_res"], size=160.0, amplitude=20.0,
                                           seed=1), device=dev)
    positions = deformed_frames(scene)
    w, h = SIZES["pp_w"], SIZES["pp_h"]
    cam = pt.make_camera(eye=(110.0, 90.0, 140.0), target=(0.0, 0.0, 0.0), width=w,
                         height=h, device=dev)
    o, d = generate_rays(cam)
    o = dispatch._tile_major(o, h, w, 32).contiguous()
    d = dispatch._tile_major(d, h, w, 32).contiguous()
    F = positions.shape[0]
    group = pp.get_group("pp")
    tdist.barrier(group=group)
    K1.launches = 0
    got = pipeline_pp.render_frames_pipelined(scene, positions, o, d, pp)
    torch.cuda.synchronize()
    out = {"triangles": int(scene.count), "frames": F, "rays_per_frame": int(o.shape[0]),
           "stage": pp.coords["pp"], "k1_launches": K1.launches}
    times = []
    for _ in range(SIZES["iters"]):
        tdist.barrier(group=group)
        t0 = time.perf_counter()
        pipeline_pp.render_frames_pipelined(scene, positions, o, d, pp)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / F)
    out["pipelined_ms_per_frame"] = times
    if pp.coords["pp"] == 1:

        def frame(i, impl="auto"):
            s2 = pt.deform_scene(scene, positions[i])
            return dispatch.trace_rays(s2, pt.build_bvh(s2, builder="karras"), o, d, impl=impl)

        def serial():
            return [frame(i) for i in range(F)]

        want = serial()
        out["bit_identical_to_serial"] = all(
            torch.equal(_bits(getattr(got, f)[i]), _bits(getattr(want[i], f)))
            for i in range(F) for f in ("t", "tri", "u", "v"))
        first = {f: getattr(got, f)[0] for f in ("t", "tri", "u", "v")}
        out["frame_0_bit_identical_to_plain4"] = bit_identical(
            first, _fields(frame(0, "plain4")), "pipelined frame 0 vs plain4")
        out["hit_fraction"] = float((got.t != pt.constants.MAX_FLOAT).float().mean())
        out["serial_ms_per_frame"] = [x / F for x in _ms(serial, SIZES["iters"])]
    tdist.barrier(group=group)
    return out


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn_workers(world: int, limit_s: float) -> list:
    """Start ``world`` spawned workers, collect one dict from each (draining
    the queue before the joins), and fail if any worker errs, exits non-zero
    or outlives ``limit_s``; every worker is ended either way."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=worker, args=(r, world, port, limit_s, q))
             for r in range(world)]
    for p in procs:
        p.start()
    got, deadline = [], time.monotonic() + limit_s + 30
    try:
        while len(got) < world:
            got.append(q.get(timeout=max(1.0, deadline - time.monotonic())))
            if "error" in got[-1]:
                raise RuntimeError(f"rank {got[-1]['rank']} failed:\n{got[-1]['error']}")
        for p in procs:
            p.join(timeout=60)
        codes = [p.exitcode for p in procs]
        if codes != [0] * world:
            raise RuntimeError(f"worker exit codes {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return sorted(got, key=lambda r: r["rank"])


def gloo_group(workers: list, refs: dict, world: int) -> dict:
    """Assemble every case's rows from the ranks, hold them to step 1, and
    summarise launches, exchange and times."""
    out = {"world": world, "backend": workers[0]["backend"],
           "initialized": all(w["initialized"] for w in workers),
           "setup_s_max": max(w["setup_s"] for w in workers), "cases": {}}
    tp = workers[0]["host_mesh"]["shape"][1]
    for key in workers[0]["cases"]:
        name, n = key.split("@")
        n = int(n)
        ref, sharded1 = refs[n]
        blocks = {}
        for w in workers:
            e = w["cases"][key]
            if "rows" in e:
                blocks.setdefault(e["start"], e["rows"])
        for w in workers:  # replicas agree with the block that travelled
            e = w["cases"][key]
            want = {k: _digest(v) for k, v in blocks[e["start"]].items()}
            if e["digest"] != want:
                raise AssertionError(f"{key}: rank {w['rank']}'s rows differ from its replica's")
        rows = {f: np.concatenate([blocks[s][f] for s in sorted(blocks)])
                for f in blocks[min(blocks)]}
        if rows["t"].shape[0] != n:
            raise AssertionError(f"{key}: {rows['t'].shape[0]} rows assembled, not {n}")
        entry = {"held_to": "plain4" if n == PLAIN_AT else "cuda4",
                 "parity": hold(rows, ref, None if name == "dp_8x1" else sharded1),
                 "k1_launches_per_rank": [w["cases"][key]["k1_launches"] for w in workers],
                 "host_reads_per_rank": [w["cases"][key]["host_reads"] for w in workers],
                 "ms_per_rank_median": [statistics.median(w["cases"][key]["ms"])
                                        for w in workers]}
        if n == PLAIN_AT:
            entry["cuda4_bit_identical_to_plain4_per_rank"] = [
                w["cases"][key]["cuda4_bit_identical_to_plain4"] for w in workers]
        entry["ms_slowest_rank"] = max(entry["ms_per_rank_median"])
        if name.startswith("shuffle"):
            sent = sum(w["cases"][key]["copies_sent"] for w in workers)
            entry["copies_sent"] = sent
            entry["exchange_fraction"] = sent / (n * tp)
        out["cases"][key] = entry
    return out


def run() -> dict:
    """Steps 1-4 on the card; returns the phase's fields.  Raises on any
    failure."""
    import torch.distributed as tdist

    from unitysimpleraytracing_tpu_torch.ops import trace_bvh4

    t0 = time.perf_counter()
    trace_bvh4._load_kernel()  # built here, before any worker starts
    fields = {"sizes": SIZES}
    try:
        fields["world_1"], refs = world_one()
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()
    fields["world_1_seconds"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    workers = spawn_workers(WORLD, LIMIT_S)
    fields["gloo_8_ranks"] = gloo_group(workers, refs, WORLD)
    fields["gloo_8_ranks"]["timing"] = (
        f"{WORLD} processes sharing one card over gloo (host clock, median of "
        f"{SIZES['iters']} after a warm-up, barrier-aligned): not scaling")
    fields["multihost"] = {
        "initialize_returned": [w["initialized"] for w in workers],
        "host_mesh": [w["host_mesh"] for w in workers],
        "tp_rows_within_a_host": all(
            {r // 4 for r in w["host_mesh"]["tp_row"]} == {w["rank"] // 4} for w in workers),
        "ingest_equals_full": workers[0]["ingest_equals_full"],
    }
    pipe = [w["pipeline"] for w in workers if "pipeline" in w]
    fields["pipeline"] = {"stages": pipe}
    fields["gloo_seconds"] = time.perf_counter() - t1
    _check(fields, workers, WORLD)
    return fields


def _check(fields: dict, workers: list, world: int) -> None:
    mh = fields["multihost"]
    if not all(mh["initialize_returned"]):
        raise AssertionError("multihost.initialize returned False in a multi-process group")
    for w in workers:
        if w["host_mesh"]["shape"] != [world // 4, 4]:
            raise AssertionError(f"make_host_mesh gave {w['host_mesh']['shape']}")
    if not mh["tp_rows_within_a_host"]:
        raise AssertionError("a tp row spans two hosts")
    ing = mh["ingest_equals_full"]
    if not all(ing[f] for f in ("morton", "aabb_min", "aabb_max")):
        raise AssertionError(f"per-host ingest differs from the full ingest: {ing}")
    stages = {p["stage"]: p for p in fields["pipeline"]["stages"]}
    if set(stages) != {0, 1} or not stages[1]["bit_identical_to_serial"]:
        raise AssertionError("the pipelined frames differ from the serial frames")


def main() -> int:
    if not torch.cuda.is_available():
        print("dist_path: no CUDA device available", file=sys.stderr)
        return 1
    print(json.dumps({"phase": "dist_path", **run()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
