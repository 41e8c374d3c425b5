"""Large scenes on one device: chunked BVH build, traversal and frames.

Counterpart of ``unitysimpleraytracing_tpu/pipeline/chunked.py``.  A scene
too large for one tree — or one the caller chooses to split — is cut into
Morton-contiguous chunks (`parallel/dist.partition_scene`), each chunk gets
its own tree and record table, and rays fold a running best hit over the
chunks, one traversal kernel launch per chunk.  The chunks are traced
near-first from the rays' mean origin, and each chunk starts from the
running best as its ``t_init``, so the far chunks prune most of their walk
at the root.

Tie semantics: the fold is strict-<, so an equal-t hit resolves to the chunk
traced first; within a chunk, DFS order.  The same bounded exact-tie class
as the reference's single tree (ROADMAP, parity contract).

How the port differs from the JAX package, on purpose:

- Chunks are built in a host loop, one tree after another (the port's SAH
  builders are themselves host loops of one level per iteration); JAX vmaps
  over chunks.  `build_bvh_chunked` is therefore a build of S trees, and
  ``chip_smoke.py`` records its time.
- There is no traced build (`_build_bvh_chunked_traced` of JAX): PyTorch
  runs eagerly, and ``builder=None`` always means "sah".
- The chunk capacity is bounded by the record ids the port's kernels decode
  (21 bits for BVH4 records, 20 for binary ones), not by the TPU's 88 MB
  VMEM table budget; `_check_chunk_records` raises `CapacityError` on it.
- Binary chunk tables are the flat ``(cap, 32)`` layout of
  `trace_bvh2.pack_tables`; the JAX package's ``pack`` = 2 or 4 views of
  the same bytes are not made here (`io/checkpoint` reads them).
- `trace_chunked` has no ``rows`` or ``popn``: those shape the TPU kernel's
  ray packets, and the port's kernels trace one ray per thread.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import torch

from unitysimpleraytracing_tpu_torch import constants as C
from unitysimpleraytracing_tpu_torch.core.camera import Camera, generate_rays
from unitysimpleraytracing_tpu_torch.core.types import Bvh, HitRecord, Scene, Triangles
from unitysimpleraytracing_tpu_torch.core.types import _Replace
from unitysimpleraytracing_tpu_torch.ops import sah, trace, trace_bvh2, trace_bvh4
from unitysimpleraytracing_tpu_torch.ops.dispatch import (
    MAX_CAPACITY, CapacityError, _row_major, _tile_major, trace_rays,
)
from unitysimpleraytracing_tpu_torch.parallel import dist
from unitysimpleraytracing_tpu_torch.parallel.dist import ShardedScene, take_rows
from unitysimpleraytracing_tpu_torch.pipeline.build import BUILDERS

RECORD_FORMATS = ("bvh4", "bvh2")


@dataclass(eq=False)
class ChunkedBvh(_Replace):
    """Morton-range chunked scene + one tree per chunk (every Bvh field
    stacked on axis 0) + the chunks' record tables, packed once at build
    time: (S, cap4, 64) BVH4 records or (S, cap, 32) binary records."""

    sscene: ShardedScene
    bvhs: Bvh             # every field stacked (S, ...); count = chunk capacity
    tables: torch.Tensor  # (S, rows, 64 | 32) float32

    @property
    def num_chunks(self) -> int:
        return self.sscene.num_shards

    @property
    def capacity(self) -> int:
        return self.sscene.shard_capacity


def _check_chunk_records(record_format: str, records: int, capacity: int,
                         chunk_capacity: int) -> None:
    """Build-time capacity contract of the chunked path: a chunk's record
    table must fit the record ids that the traversal kernels decode (21 bits
    in the BVH4 metas, 20 in the binary ones).  Raises `CapacityError`
    naming the limit that was hit."""
    if record_format == "bvh4" and max(records, capacity) > MAX_CAPACITY:
        raise CapacityError(
            f"chunk_capacity={chunk_capacity} gives chunks of {capacity} triangles "
            f"and {records} BVH4 records, over the 21-bit record and triangle ids "
            f"of the BVH4 metas ({MAX_CAPACITY}); use a smaller chunk_capacity"
        )
    if record_format == "bvh2" and capacity > trace_bvh2.MAX_CAPACITY:
        raise CapacityError(
            f"chunk_capacity={chunk_capacity} gives chunks of {capacity} triangles, "
            f"over the 20-bit ids of the binary-record metas "
            f"({trace_bvh2.MAX_CAPACITY}); use a smaller chunk_capacity or "
            f"record_format='bvh4'"
        )


def _local_build_sweep(build_fn, morton_l, aabb_min_l, aabb_max_l, count: int) -> Bvh:
    """Per-chunk sweep-SAH build, ``build_fn`` being
    `sah.build_bvh_sah_from_sorted` ("sah") or `sah.build_bvh_sah_free`
    ("sah_free", which re-orders the leaves per node from this Morton
    seed); the same clamp of the count to 2 as `dist._local_build`."""
    cap = morton_l.shape[0]
    iota = torch.arange(cap, dtype=torch.int32, device=morton_l.device)
    _, perm = torch.sort(morton_l, stable=True)
    return build_fn(iota[perm], aabb_min_l, aabb_max_l, max(int(count), 2), static_count=cap)


_SWEEP_BUILDERS = {"sah": sah.build_bvh_sah_from_sorted, "sah_free": sah.build_bvh_sah_free}


_BVH_ARRAYS = tuple(f.name for f in dataclasses.fields(Bvh) if f.name != "count")


def _stack_bvhs(bvhs: list[Bvh]) -> Bvh:
    return Bvh(**{f: torch.stack([getattr(b, f) for b in bvhs]) for f in _BVH_ARRAYS},
               count=bvhs[0].count)


@torch.no_grad()
def _partition_build(scene: Scene, num_chunks: int, builder: str):
    """(ShardedScene, list of per-chunk Bvh): the partition, then one tree
    per chunk in a host loop (one host read of the S chunk counts)."""
    sscene = dist.partition_scene(scene, num_chunks)
    if builder in _SWEEP_BUILDERS:
        fn = functools.partial(_local_build_sweep, _SWEEP_BUILDERS[builder])
    else:
        fn = dist._local_build
    counts = sscene.counts.tolist()
    bvhs = [
        fn(sscene.morton[s], sscene.aabb_min[s], sscene.aabb_max[s], counts[s])
        for s in range(num_chunks)
    ]
    return sscene, bvhs


@torch.no_grad()
def build_bvh_chunked(
    scene: Scene,
    chunk_capacity: int = 163840,
    record_format: str = "bvh4",
    builder: str | None = None,
) -> ChunkedBvh:
    """Partition the scene into ceil(n / chunk_capacity) Morton ranges and
    build one tree and one record table per chunk.

    ``record_format``: "bvh4" packs the 4-child records of `trace_bvh4`
    (the main path's kernel), "bvh2" the binary records of `trace_bvh2`.
    The table's row width tells `trace_chunked` which kernel to launch.

    ``builder``: the per-chunk topology builder, "karras", "sah" or
    "sah_free".  ``None`` means "sah", the JAX package's default here: the
    chunked path exists for large static scenes, where the one-time build
    buys every frame.

    The chunks are built one after another in a host loop (JAX vmaps over
    them); each SAH build is itself a host loop of one tree level per
    iteration.  BVH4 tables are sized to the ACTUAL largest per-chunk record
    count (one host read per chunk at build time), not the worst-case
    (2n+1)/3 bound.  Raises `CapacityError` when a chunk exceeds the record
    ids the kernels decode."""
    if builder is None:
        builder = "sah"
    if builder not in BUILDERS:
        raise ValueError(f"unknown builder {builder!r}; one of {BUILDERS}")
    if record_format not in RECORD_FORMATS:
        raise ValueError(f"unknown record_format {record_format!r}; one of {RECORD_FORMATS}")
    n = scene.count
    num_chunks = max(-(-n // chunk_capacity), 1)
    sscene, chunk_bvhs = _partition_build(scene, num_chunks, builder)
    cap = sscene.shard_capacity
    if record_format == "bvh4":
        _check_chunk_records("bvh4", 0, cap, chunk_capacity)
        infos = [trace_bvh4._node_mask_cached(b) for b in chunk_bvhs]
        cap4 = max(max(c for _, _, c in infos), 1)
        _check_chunk_records("bvh4", cap4, cap, chunk_capacity)
        tables = torch.stack([
            trace_bvh4.pack_tables4(
                _chunk_scene(sscene, s, cap), chunk_bvhs[s],
                cap4=cap4, mask=infos[s][0], new_id=infos[s][1],
            )
            for s in range(num_chunks)
        ])
    else:
        _check_chunk_records("bvh2", 0, cap, chunk_capacity)
        tables = torch.stack([
            trace_bvh2.pack_tables(_chunk_scene(sscene, s, cap), chunk_bvhs[s])
            for s in range(num_chunks)
        ])
    return ChunkedBvh(sscene=sscene, bvhs=_stack_bvhs(chunk_bvhs), tables=tables)


def _chunk_scene(ss: ShardedScene, s: int, cap: int) -> Scene:
    """Chunk s as a Scene of views (no copies)."""
    tris = Triangles(
        a=ss.tri_a[s], b=ss.tri_b[s], c=ss.tri_c[s],
        a_uv=ss.a_uv[s], b_uv=ss.b_uv[s], c_uv=ss.c_uv[s],
        a_normal=ss.a_normal[s], b_normal=ss.b_normal[s], c_normal=ss.c_normal[s],
        count=cap,
    )
    return Scene(
        triangles=tris, aabb_min=ss.aabb_min[s], aabb_max=ss.aabb_max[s],
        morton=ss.morton[s], tri_index=ss.global_tri[s], count=cap,
    )


def _chunk_bvh(bvhs: Bvh, s: int, cap: int) -> Bvh:
    """Tree s of a stacked Bvh, as views."""
    return Bvh(**{f: getattr(bvhs, f)[s] for f in _BVH_ARRAYS}, count=cap)


def resolve_chunk_impl(impl: str, width: int, device) -> str:
    """The traversal engine for a chunk table of ``width`` slots per row:
    64 = BVH4 records, 32 = binary records; "auto" is the kernel on a CUDA
    device and its plain version on the CPU."""
    four = width == 64
    if width not in (64, 32):
        raise ValueError(f"not a chunk record table: {width} slots per row")
    if impl == "auto":
        cuda = torch.device(device).type == "cuda"
        return ("cuda4" if cuda else "plain4") if four else ("cuda2" if cuda else "plain2")
    if impl not in ("cuda4", "plain4", "cuda2", "plain2"):
        raise ValueError(f"trace_chunked takes impl auto, cuda4, plain4, cuda2 or "
                         f"plain2, got {impl!r}")
    if (impl in ("cuda4", "plain4")) != four:
        raise ValueError(f"impl={impl!r} does not read tables of {width} slots per row")
    return impl


def _root_boxes(cbvh: ChunkedBvh):
    return cbvh.bvhs.node_aabb_min[:, 0], cbvh.bvhs.node_aabb_max[:, 0]


@torch.no_grad()
def trace_chunked(
    cbvh: ChunkedBvh,
    origins: torch.Tensor,
    dirs: torch.Tensor,
    impl: str = "auto",
    route: bool = True,
    anyhit_thresh: torch.Tensor | None = None,
    compact: int | None | str = "auto",
) -> HitRecord:
    """Nearest hit over all chunks; ``tri`` is the ORIGINAL scene triangle id.

    Chunks are traced NEAR-FIRST, by the distance from the rays' mean origin
    to each chunk's root box: the running best, passed to each chunk as its
    ``t_init``, then prunes most of the far chunks' walk at the root.  The
    result is exact for any order (a pruned candidate can never win the
    strict-< fold); only EXACT cross-chunk t-ties resolve to the chunk traced
    first.  The schedule is read to the host once per call (S integers: one
    device-to-host sync), so each launch gets its chunk's table as a view,
    not a copy.

    ``route=True`` reorders the RAYS once, stably, by each ray's nearest
    overlapped chunk root box (rays that overlap none go to the tail), and
    unpermutes the results at the end: the same fold over the same
    candidates, so the same hits as ``route=False``.

    ``compact`` = the schedule position after which the rays that some
    remaining chunk can still improve (its raw root-slab tmin below the ray's
    best t) are packed to the front: the tail chunks fold into a fresh best
    state seeded with the permuted running best, merged back by strict-< at
    the end.  "auto" means off (the JAX package measured it a loss for
    tile-major camera rays); ``None`` is off.

    ``impl``: "auto" (the kernel on the card, its plain version on the CPU)
    or an engine matching the table's row width: "cuda4" / "plain4" for 64
    slots, "cuda2" / "plain2" for 32.  The JAX package's
    ``rows`` and ``popn`` shape its TPU ray packets and have no counterpart.
    """
    S, cap = cbvh.num_chunks, cbvh.capacity
    R = origins.shape[0]
    dev = origins.device
    impl = resolve_chunk_impl(impl, cbvh.tables.shape[-1], dev)
    if compact == "auto":
        compact = None
    if compact is not None and not (0 <= compact < S - 1):
        raise ValueError(
            f"compact={compact} is out of range for {S} chunks (valid: 0..{S - 2}, "
            f"a position with chunks remaining after it); use compact=None to disable"
        )
    roots_min, roots_max = _root_boxes(cbvh)
    # Near-first schedule from the mean origin (exact for any order).
    eye = origins.mean(dim=0)
    gap = torch.minimum(torch.maximum(eye, roots_min), roots_max) - eye
    dist2 = (gap[:, 0] * gap[:, 0] + gap[:, 1] * gap[:, 1]) + gap[:, 2] * gap[:, 2]
    perm = torch.argsort(dist2, stable=True)
    schedule = perm.tolist()

    # Pad the batch once to whole warps (copies of ray 0, sliced off at the
    # end), so no per-chunk call pads it again.
    pad = (-R) % trace_bvh4.RAY_MULTIPLE
    if pad:
        origins = torch.cat([origins, origins[:1].expand(pad, 3)])
        dirs = torch.cat([dirs, dirs[:1].expand(pad, 3)])
        if anyhit_thresh is not None:
            anyhit_thresh = torch.cat([anyhit_thresh, anyhit_thresh.new_zeros(pad)])
    Rp = R + pad

    gate = ov = tmin = None
    if (route or compact is not None) and S > 1:
        # Root-slab distances per (ray, chunk); inf where no overlap.
        inv = 1.0 / dirs
        lo = hi = None
        for ax in range(3):
            t1 = (roots_min[None, :, ax] - origins[:, ax, None]) * inv[:, ax, None]
            t2 = (roots_max[None, :, ax] - origins[:, ax, None]) * inv[:, ax, None]
            a, b = torch.minimum(t1, t2), torch.maximum(t1, t2)
            lo = a if lo is None else torch.maximum(lo, a)
            hi = b if hi is None else torch.minimum(hi, b)
        tmin, tmax = lo, hi
        ov = (tmax > tmin) & (tmax > 0)
        gate = torch.where(ov, tmin, torch.inf)  # raw tmin: exact liveness bound

    ray_perm = None
    if route and S > 1:
        entry = torch.where(ov, torch.clamp(tmin, min=0.0), torch.inf)
        nearest = torch.where(ov.any(dim=1), torch.argmin(entry, dim=1), S)
        ray_perm = torch.argsort(nearest, stable=True)
        origins, dirs = take_rows(origins, ray_perm), take_rows(dirs, ray_perm)
        if compact is not None:
            gate = take_rows(gate, ray_perm)
        if anyhit_thresh is not None:
            anyhit_thresh = anyhit_thresh[ray_perm]
    if compact is not None:
        # Gate columns in schedule order.
        gate = gate[:, perm]
    origins, dirs = origins.contiguous(), dirs.contiguous()

    f32 = dict(dtype=torch.float32, device=dev)
    best_t = torch.full((Rp,), C.MAX_FLOAT, **f32)
    best_tri = torch.zeros((Rp,), dtype=torch.int32, device=dev)  # LOCAL id
    best_chunk = torch.zeros((Rp,), dtype=torch.int32, device=dev)
    best_u = torch.zeros((Rp,), **f32)
    best_v = torch.zeros((Rp,), **f32)
    head = tail_perm = None
    for s, idx in enumerate(schedule):
        # Later chunks prune against the best found so far (exact: a hit at
        # or beyond best_t loses the strict-< fold).  Any-hit: a collapsed
        # t = 0 from one chunk makes the next chunk's t_init 0, which prunes
        # its whole walk for that ray.
        h = trace_rays(
            _chunk_scene(cbvh.sscene, idx, cap), _chunk_bvh(cbvh.bvhs, idx, cap),
            origins, dirs, impl=impl, t_init=best_t, tables=cbvh.tables[idx],
            anyhit_thresh=anyhit_thresh,
        )
        win = h.t < best_t  # ties: the chunk traced first keeps the hit
        best_t = torch.where(win, h.t, best_t)
        best_tri = torch.where(win, h.tri, best_tri)
        best_chunk = torch.where(win, idx, best_chunk)
        best_u = torch.where(win, h.u, best_u)
        best_v = torch.where(win, h.v, best_v)
        if s == compact:
            live = (gate[:, s + 1:] < best_t[:, None]).any(dim=1)
            tail_perm = torch.argsort((~live).to(torch.int32), stable=True)
            origins = take_rows(origins, tail_perm).contiguous()
            dirs = take_rows(dirs, tail_perm).contiguous()
            if anyhit_thresh is not None:
                anyhit_thresh = anyhit_thresh[tail_perm]
            head = (best_t, best_tri, best_chunk, best_u, best_v)
            best_t = best_t[tail_perm]
            best_tri = torch.zeros_like(best_tri)
            best_chunk = torch.zeros_like(best_chunk)
            best_u = torch.zeros_like(best_u)
            best_v = torch.zeros_like(best_v)

    if head is not None:
        # Unpermute the tail fold and merge: the tail wins only by strict <
        # of its seeded t_init, so an equal t keeps the head's hit.
        inv_p = _inverse(tail_perm)
        head_t, head_tri, head_chunk, head_u, head_v = head
        tail_t = best_t[inv_p]
        win = tail_t < head_t
        best_t = torch.where(win, tail_t, head_t)
        best_u = torch.where(win, best_u[inv_p], head_u)
        best_v = torch.where(win, best_v[inv_p], head_v)
        best_tri = torch.where(win, best_tri[inv_p], head_tri)
        best_chunk = torch.where(win, best_chunk[inv_p], head_chunk)
    flat = best_chunk.to(torch.int64) * cap + best_tri.to(torch.int64)
    gtri = cbvh.sscene.global_tri.reshape(-1)[flat]
    gtri = torch.where(best_t < C.MAX_FLOAT, gtri, 0)  # miss: triangle 0
    if ray_perm is not None:
        inv_r = _inverse(ray_perm)
        best_t, gtri, best_u, best_v = best_t[inv_r], gtri[inv_r], best_u[inv_r], best_v[inv_r]
    return HitRecord(t=best_t[:R], tri=gtri[:R], u=best_u[:R], v=best_v[:R])


def _inverse(perm: torch.Tensor) -> torch.Tensor:
    """Inverse of a permutation (one scatter of the iota)."""
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], dtype=perm.dtype, device=perm.device)
    return inv


@torch.no_grad()
def render_hits_chunked(
    scene: Scene, cbvh: ChunkedBvh, cam: Camera, impl: str = "auto",
    route: bool = False, compact: int | None | str = "auto",
) -> HitRecord:
    """Primary rays of a chunked scene, traced in 32x32 tile-major order and
    returned in row-major pixel order (ops/dispatch.camera_trace's recipe);
    ``scene`` is the original unchunked scene (shading reads it).  ``route``
    is off by default here, as in the JAX package: tile-major camera rays
    already meet the chunks coherently."""
    origins, dirs = generate_rays(cam)
    h, w = cam.height, cam.width
    if h % 32 == 0 and w % 32 == 0:
        hits = trace_chunked(
            cbvh, _tile_major(origins, h, w, 32), _tile_major(dirs, h, w, 32),
            impl=impl, route=route, compact=compact,
        )
        return HitRecord(
            t=_row_major(hits.t, h, w, 32), tri=_row_major(hits.tri, h, w, 32),
            u=_row_major(hits.u, h, w, 32), v=_row_major(hits.v, h, w, 32),
        )
    return trace_chunked(cbvh, origins, dirs, impl=impl, route=route, compact=compact)


def occlusion_rays_chunked(cbvh: ChunkedBvh, origins, dirs, eps: float = 4e-3,
                           origin_bound=None):
    """The backward any-hit query of `occluded_chunked` as ray tensors,
    ``(back_origins, back_dirs, thresh, limit)``: `ops/dispatch.occlusion_rays`
    with the scene's extent taken from the chunk roots."""
    roots_min, roots_max = _root_boxes(cbvh)

    def finite(x):
        return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)

    ext = torch.maximum(finite(roots_min).abs().max(), finite(roots_max).abs().max())
    obound = origins.abs().max() if origin_bound is None else origin_bound
    far = 4.0 * ext + obound + 1.0
    limit = far - eps
    thresh = limit.expand(origins.shape[0]).contiguous()
    return origins + dirs * far, -dirs, thresh, limit


@torch.no_grad()
def occluded_chunked(
    cbvh: ChunkedBvh, origins, dirs, impl: str = "auto", eps: float = 4e-3,
    origin_bound=None,
) -> torch.Tensor:
    """Occlusion over a chunked scene (`ops/dispatch.occluded`'s semantics):
    traced backward from outside the whole scene with the any-hit early exit
    in every chunk; ``t_init`` carries the collapse across chunks.

    ``origin_bound`` optionally replaces the batch-derived ``max|origins|``
    term of the far scale with a caller bound — the frame-invariant form
    that makes batched shadow passes bit-identical to per-frame calls."""
    back_origins, back_dirs, thresh, limit = occlusion_rays_chunked(
        cbvh, origins, dirs, eps, origin_bound)
    hits = trace_chunked(cbvh, back_origins, back_dirs, impl=impl, anyhit_thresh=thresh)
    return hits.hit & (hits.t < limit)


def _shadow_rays_chunked(cbvh: ChunkedBvh, hits: HitRecord, o, d):
    """Shadow rays over a chunked scene (render._shadow_rays_from's recipe):
    hit points from origin + t·dir, guaranteed-miss substitutes for miss
    pixels, and a FRAME-INVARIANT origin bound derived from the chunk roots
    alone, so batched shadow passes equal per-frame calls bit for bit."""
    dev = o.device
    light = (1.0 / torch.sqrt(torch.tensor(3.0, dtype=torch.float32, device=dev))).expand(3)
    roots_min, roots_max = _root_boxes(cbvh)
    root_max = torch.nan_to_num(roots_max, nan=0.0, posinf=0.0, neginf=0.0).amax(dim=0)
    roots_min = torch.nan_to_num(roots_min, nan=0.0, posinf=0.0, neginf=0.0)
    miss_o = root_max + torch.clamp(root_max.abs().max(), min=1.0)
    miss_d = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float32, device=dev)
    hitm = hits.hit[:, None]
    p = o + torch.where(hitm, hits.t[:, None], 0.0) * d
    dirs = torch.where(hitm, light[None, :], miss_d[None, :])
    origins = torch.where(hitm, p + light[None, :] * 1e-3, miss_o[None, :])
    ext = torch.maximum(roots_min.abs().max(), root_max.abs().max())
    origin_bound = torch.maximum(miss_o.abs().max(), ext + 1.0)
    return origins, dirs, origin_bound


@torch.no_grad()
def render_rgba_chunked(
    scene: Scene, cbvh: ChunkedBvh, cam: Camera, tex, impl: str = "auto",
    shadows: bool = False,
) -> torch.Tensor:
    """Traced layer (H, W, 4) of a chunked scene, row 0 = bottom
    (`pipeline/render.render_rgba`'s contract, shadow pass included)."""
    hits = render_hits_chunked(scene, cbvh, cam, impl=impl)
    shadow = None
    if shadows:
        o, d = generate_rays(cam)
        origins, dirs, origin_bound = _shadow_rays_chunked(cbvh, hits, o, d)
        h, w = cam.height, cam.width
        if h % 32 == 0 and w % 32 == 0:
            occ = occluded_chunked(
                cbvh, _tile_major(origins, h, w, 32), _tile_major(dirs, h, w, 32),
                impl=impl, origin_bound=origin_bound,
            )
            shadow = _row_major(occ, h, w, 32) & hits.hit
        else:
            shadow = occluded_chunked(
                cbvh, origins, dirs, impl=impl, origin_bound=origin_bound
            ) & hits.hit
    rgba = trace.shade(scene, tex, hits, shadow=shadow)
    return rgba.reshape(cam.height, cam.width, 4)


@torch.no_grad()
def render_frame_chunked(
    scene: Scene, cbvh: ChunkedBvh, cam: Camera, tex, background,
    impl: str = "auto", shadows: bool = False,
) -> torch.Tensor:
    """Full composited frame (H, W, 4) of a chunked scene
    (`pipeline/render.render_frame`'s contract)."""
    traced = render_rgba_chunked(scene, cbvh, cam, tex, impl=impl, shadows=shadows)
    bg = torch.as_tensor(background, dtype=torch.float32, device=traced.device)
    return trace.compose(bg.expand(cam.height, cam.width, 3), traced)


@torch.no_grad()
def render_frames_chunked(
    scene: Scene, cbvh: ChunkedBvh, cams: Camera, tex, background,
    impl: str = "auto", shadows: bool = False,
) -> torch.Tensor:
    """(F, H, W, 4) frames of a chunked scene from F stacked cameras
    (`core.camera.stack_cameras`): all frames' tile-major rays fold over the
    chunks as ONE batch, so each chunk's launch is paid once per batch, not
    once per frame.

    Equal to F `render_frame_chunked` calls bit for bit, up to one bounded
    edge: the near-first schedule comes from the BATCH's mean origin, so an
    EXACT cross-chunk t-tie may resolve to another chunk.  Width and height
    must be multiples of 32."""
    if cams.cam_to_world.ndim != 3:
        raise ValueError("render_frames_chunked takes stacked cameras (stack_cameras)")
    f = cams.cam_to_world.shape[0]
    h, w = cams.height, cams.width
    if h % 32 or w % 32:
        raise ValueError("batched frames need 32-divisible dims")
    # An (F*H, W) image in tile-major order IS the per-frame tile-major
    # orders one after another, because H is a whole number of tiles.
    o, d = generate_rays(cams)
    ot = _tile_major(o.reshape(f * h * w, 3), f * h, w, 32)
    dt = _tile_major(d.reshape(f * h * w, 3), f * h, w, 32)
    hits = trace_chunked(cbvh, ot, dt, impl=impl, route=False)

    shadow = None
    if shadows:
        so, sd, origin_bound = _shadow_rays_chunked(cbvh, hits, ot, dt)
        shadow = occluded_chunked(
            cbvh, so, sd, impl=impl, origin_bound=origin_bound
        ) & hits.hit
        shadow = _row_major(shadow, f * h, w, 32)
    hits = HitRecord(
        t=_row_major(hits.t, f * h, w, 32), tri=_row_major(hits.tri, f * h, w, 32),
        u=_row_major(hits.u, f * h, w, 32), v=_row_major(hits.v, f * h, w, 32),
    )
    rgba = trace.shade(scene, tex, hits, shadow=shadow).reshape(f, h, w, 4)
    bg = torch.as_tensor(background, dtype=torch.float32, device=rgba.device)
    return trace.compose(bg.expand(h, w, 3), rgba)
