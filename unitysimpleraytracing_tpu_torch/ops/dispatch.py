"""Traversal implementation dispatch.

Six interchangeable traversal engines, one contract (hit records agree up
to exact-t ties):

- ``cuda4``  — the hand-written CUDA kernel over BVH4 records
  (ops/trace_bvh4.traverse_bvh4): the main path on the card.
- ``plain4`` — the same BVH4 traversal in plain PyTorch
  (traverse_bvh4_plain): what the CPU runs; on CUDA tensors it runs only when
  asked for by name (to compare against the kernel).
- ``cuda2``  — the hand-written CUDA kernel over binary records
  (ops/trace_bvh2.traverse_bvh2): one tree level per record fetch; the
  engine of the dynamic paths that re-pack the whole table per frame.
- ``plain2`` — the same binary-record traversal in plain PyTorch
  (traverse_bvh2_plain).
- ``packet`` — shared-stack packets of 1024 rays in plain PyTorch
  (ops/trace_packet.traverse_packets), bit-identical to ``perray``.
- ``perray`` — per-ray BVH2 stacks in the original shader's visit order
  (ops/trace.traverse); the oracle.

``auto`` picks cuda4 when the rays are on a CUDA device, plain4 on the CPU.
"""
from __future__ import annotations

import torch

from unitysimpleraytracing_tpu_torch.core.types import Bvh, HitRecord, Scene
from unitysimpleraytracing_tpu_torch.ops import trace, trace_bvh2, trace_bvh4, trace_packet
from unitysimpleraytracing_tpu_torch.utils.profiling import span

# Single-tree envelope: the record metas hold triangle ids and record ids in
# 21 bits (ops/trace_bvh4).
MAX_CAPACITY = (1 << 21) - 1
# Rays per shared stack of the "packet" engine: one 32x32 image tile.
PACKET = 1024

_ENGINES4 = ("cuda4", "plain4")
_ENGINES2 = ("cuda2", "plain2")


class CapacityError(ValueError):
    """Scene exceeds the single-tree traversal envelope.

    The reference makes its envelope explicit by allocating everything at a
    hard 524 288-element cap (Constants.cs:3-6).  The port's envelope is the
    record meta packing: triangle and record ids below 2^21 (BVH4 records)
    or 2^20 (binary records).  Larger scenes take the chunked path:
    `pipeline/chunked.build_bvh_chunked` splits them into chunks of at most
    ``chunk_capacity`` triangles, each with its own tree, and
    `render_frame_chunked` / `trace_chunked` trace them; the same error is
    raised there when one chunk exceeds the envelope."""


def resolve_impl(impl: str, capacity: int, device) -> str:
    if impl == "auto":
        impl = "cuda4" if torch.device(device).type == "cuda" else "plain4"
    if impl in _ENGINES4 and capacity > MAX_CAPACITY:
        raise CapacityError(
            f"scene capacity {capacity} exceeds the single-tree envelope "
            f"({MAX_CAPACITY} triangles: record metas hold 21-bit ids). Build "
            f"it in chunks with build_bvh_chunked and render it with "
            f"render_frame_chunked (pipeline/chunked); impl='perray' has no "
            f"such bound."
        )
    if impl in _ENGINES2 and capacity > trace_bvh2.MAX_CAPACITY:
        raise CapacityError(
            f"scene capacity {capacity} exceeds the binary-record envelope "
            f"({trace_bvh2.MAX_CAPACITY} triangles: record metas hold 20-bit "
            f"ids). Use impl='cuda4' (BVH4 records, 21-bit ids), "
            f"build_bvh_chunked (pipeline/chunked) or impl='perray'."
        )
    return impl


@torch.no_grad()
def trace_rays(
    scene: Scene,
    bvh: Bvh,
    origins: torch.Tensor,
    dirs: torch.Tensor,
    impl: str = "auto",
    tables=None,
    t_init=None,
    anyhit_thresh=None,
) -> HitRecord:
    """Trace an (R, 3) ray batch with the chosen engine, padding R as needed.

    Rays should arrive in a coherent order (image-tile order for camera rays).
    ``tables`` optionally carries the engine's record table
    (`trace_bvh4.prepare_tables4` for cuda4/plain4, or its
    `trace_bvh4.compress_tables4` form; `trace_bvh2.prepare_tables` for
    cuda2/plain2; they are told apart by their 64, 52 or 32 slots per row)
    so a static scene is packed once, not per frame.  ``t_init`` (optional
    (R,) f32) is an exact pruning bound from a previous traversal;
    ``anyhit_thresh`` (optional (R,)
    f32, 0 = off) is the occlusion early-exit: a ray's t collapses to 0 at
    the first hit strictly below the threshold (the occlusion BOOLEAN
    ``hit & (t < thresh)`` is identical to the nearest-hit answer — the
    nearest hit is minimal, so one below-threshold hit exists iff the nearest
    is below).  The per-ray oracle and the packet engine ignore both;
    results are identical either way.
    """
    impl = resolve_impl(impl, bvh.capacity, origins.device)
    if impl == "perray":
        return trace.traverse(scene, bvh, origins, dirs)
    if impl == "packet":
        multiple = PACKET
    elif impl in _ENGINES4:
        multiple = trace_bvh4.RAY_MULTIPLE
    elif impl in _ENGINES2:
        multiple = trace_bvh2.RAY_MULTIPLE
    else:
        raise ValueError(f"unknown traversal impl {impl!r}")

    R = origins.shape[0]
    pad = (-R) % multiple
    if pad:
        origins = torch.cat([origins, origins[:1].expand(pad, 3)])
        dirs = torch.cat([dirs, dirs[:1].expand(pad, 3)])
        zeros = torch.zeros((pad,), dtype=torch.float32, device=origins.device)
        if t_init is not None:
            t_init = torch.cat([t_init, zeros])  # padding: cull all
        if anyhit_thresh is not None:
            anyhit_thresh = torch.cat([anyhit_thresh, zeros])

    if impl == "packet":
        hits = trace_packet.traverse_packets(scene, bvh, origins, dirs, packet_size=PACKET)
    else:
        if impl in _ENGINES4:
            if tables is None:
                tables = trace_bvh4.prepare_tables4(scene, bvh)
            run = trace_bvh4.traverse_bvh4 if impl == "cuda4" else trace_bvh4.traverse_bvh4_plain
        else:
            if tables is None:
                tables = trace_bvh2.prepare_tables(scene, bvh)
            run = trace_bvh2.traverse_bvh2 if impl == "cuda2" else trace_bvh2.traverse_bvh2_plain
        # A table of the other record format fails the engine's shape check.
        hits = run(
            tables, origins.contiguous(), dirs.contiguous(),
            t_init=t_init, anyhit_thresh=anyhit_thresh,
        )
    if pad:
        hits = HitRecord(t=hits.t[:R], tri=hits.tri[:R], u=hits.u[:R], v=hits.v[:R])
    return hits


def occlusion_rays(scene: Scene, origins, dirs, eps: float = 4e-3, origin_bound=None):
    """The backward any-hit query of `occluded` as ray tensors:
    ``(back_origins, back_dirs, thresh, limit)``.  A ray is occluded iff its
    trace from ``back_origins`` along ``back_dirs`` hits with ``t < limit``;
    ``thresh`` (R,) is the any-hit threshold (``limit`` for every ray)."""
    ext = torch.maximum(scene.aabb_min.abs().max(), scene.aabb_max.abs().max())
    if origin_bound is None:
        origin_bound = origins.abs().max()
    far = 4.0 * ext + origin_bound + 1.0
    limit = far - eps
    thresh = limit.expand(origins.shape[0]).contiguous()
    return origins + dirs * far, -dirs, thresh, limit


@torch.no_grad()
def occluded(
    scene: Scene,
    bvh: Bvh,
    origins: torch.Tensor,
    dirs: torch.Tensor,
    impl: str = "auto",
    eps: float = 4e-3,
    tables=None,
    origin_bound: torch.Tensor | None = None,
) -> torch.Tensor:
    """Shadow/occlusion query: True where geometry blocks the ray beyond
    ``eps`` of its origin.  A capability beyond the reference (its shading
    has no shadow rays).

    Traced BACKWARD from a point outside the scene toward the origin: the
    parity-exact engines inherit the reference's acceptance quirk of keeping
    negative-t intersections whenever the origin sits inside a triangle's
    inflated AABB (Raytracing.compute:89-103 has no t>0 test), which poisons
    forward queries that start ON a surface — the self-hit at t≈-ε wins the
    nearest-hit compare.  Starting from outside the scene no box contains the
    origin, so every accepted t is positive; anything strictly between the
    far point and ``origin + eps·dir`` is a real occluder.

    Occlusion needs a boolean, not the nearest hit: the any-hit threshold
    lets the traversal retire a ray at its FIRST qualifying hit (t collapses
    to 0, which still satisfies ``hit & t < far - eps``).

    ``origin_bound``: optional scalar upper bound on ``max|origins|``.  By
    default the far scale is derived from the actual batch, which makes the
    arithmetic depend on which rays share the call — callers that need
    batch-invariant results (the shadow passes) pass a bound derived from
    the scene alone.
    """
    back_origins, back_dirs, thresh, limit = occlusion_rays(
        scene, origins, dirs, eps, origin_bound
    )
    hits = trace_rays(
        scene, bvh, back_origins, back_dirs, impl=impl, tables=tables,
        anyhit_thresh=thresh,
    )
    return hits.hit & (hits.t < limit)


def _tile_major(x: torch.Tensor, h: int, w: int, tile: int) -> torch.Tensor:
    """Row-major (H*W, ...) → 2D-tile-major, as a reshape/transpose: each
    run of tile² rows is one tile×tile pixel block, so a warp of the kernel
    holds 32 neighbouring pixels."""
    rest = x.shape[1:]
    x = x.reshape(h // tile, tile, w // tile, tile, *rest)
    return x.transpose(1, 2).reshape(h * w, *rest)


def _row_major(x: torch.Tensor, h: int, w: int, tile: int) -> torch.Tensor:
    """Inverse of `_tile_major`."""
    rest = x.shape[1:]
    x = x.reshape(h // tile, w // tile, tile, tile, *rest)
    return x.transpose(1, 2).reshape(h * w, *rest)


@torch.no_grad()
def camera_trace(
    scene: Scene, bvh: Bvh, cam, impl: str = "auto", tables=None
) -> HitRecord:
    """Primary-ray trace in tile-major order (the reference's 32×32 thread
    groups, RaytracingMeshDrawer.cs:83), results returned in row-major pixel
    order."""
    from unitysimpleraytracing_tpu_torch.core.camera import generate_rays

    h, w = cam.height, cam.width
    tiled = h % 32 == 0 and w % 32 == 0
    with span("render.rays"):
        origins, dirs = generate_rays(cam)
        if tiled:
            origins, dirs = _tile_major(origins, h, w, 32), _tile_major(dirs, h, w, 32)
    with span("render.primary"):
        hits = trace_rays(scene, bvh, origins, dirs, impl=impl, tables=tables)
        if not tiled:
            return hits
        return HitRecord(
            t=_row_major(hits.t, h, w, 32),
            tri=_row_major(hits.tri, h, w, 32),
            u=_row_major(hits.u, h, w, 32),
            v=_row_major(hits.v, h, w, 32),
        )
