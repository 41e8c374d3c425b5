"""Frame rendering: camera rays → traversal → shading → composition.

The reference's per-frame path (``RaytracingMeshDrawer.cs:76-89``) dispatches
the traversal kernel into an RGBA16F UAV and composites in ``OnRenderImage``.
Here `render_frame` produces the final (H, W, 4) image on the scene's device;
`render_rgba` returns just the traced layer (the UAV analog).  `render_frames`
traces F stacked cameras as one ray batch; `make_animated_renderer` gives the
refit-per-frame loop of a deforming mesh.
"""
from __future__ import annotations

import numpy as np
import torch

from unitysimpleraytracing_tpu_torch.core.camera import Camera, generate_rays
from unitysimpleraytracing_tpu_torch.core.texture import Texture
from unitysimpleraytracing_tpu_torch.core.types import Bvh, HitRecord, Scene
from unitysimpleraytracing_tpu_torch.ops import lbvh, trace, trace_bvh2, trace_bvh4
from unitysimpleraytracing_tpu_torch.ops.dispatch import (
    _row_major,
    _tile_major,
    camera_trace,
    occluded,
    resolve_impl,
    trace_rays,
)
from unitysimpleraytracing_tpu_torch.pipeline.build import deform_scene, refit_bvh
from unitysimpleraytracing_tpu_torch.utils.profiling import span


def _prepared(scene: Scene, bvh: Bvh, impl: str):
    """The record table, packed once per (scene, bvh) — the Awake/Update
    split of the reference (tables are frame-invariant,
    RaytracingMeshDrawer.cs:30-84)."""
    if impl in ("cuda4", "plain4"):
        return trace_bvh4.prepare_tables4(scene, bvh)
    if impl in ("cuda2", "plain2"):
        return trace_bvh2.prepare_tables(scene, bvh)
    return None


def _resolve(bvh: Bvh, cam: Camera, impl: str) -> str:
    return resolve_impl(impl, bvh.capacity, cam.cam_to_world.device)


@torch.no_grad()
def render_hits(scene: Scene, bvh: Bvh, cam: Camera, impl: str = "auto") -> HitRecord:
    impl = _resolve(bvh, cam, impl)
    return camera_trace(scene, bvh, cam, impl=impl, tables=_prepared(scene, bvh, impl))


def _shadow_origin_bound(scene, miss_o):
    """Scene-derived upper bound on max|shadow origin| (see _shadow_mask):
    hit-point origins lie within the scene box plus the 1e-3 light offset
    (≤ ext + 1), miss pixels use the concrete miss_o."""
    ext = torch.maximum(scene.aabb_min.abs().max(), scene.aabb_max.abs().max())
    return torch.maximum(miss_o.abs().max(), ext + 1.0)


def shadow_rays(scene, bvh, hits, cam, substitute=True):
    """Shadow rays of one frame, in row-major pixel order (see
    `_shadow_rays_from`)."""
    o, d = generate_rays(cam)
    return _shadow_rays_from(scene, bvh, hits, o, d, substitute)


def _shadow_rays_from(scene, bvh, hits, o, d, substitute=True):
    """Shadow rays toward the reference's fixed directional light (1,1,1) for
    the primary rays ``o``, ``d`` (R, 3) and their ``hits``, in the same
    order: ``(origins, dirs, origin_bound)``.  Rays start at the hit point,
    offset along the light to avoid self-intersection.  Every operation is
    per ray, so one frame's rays come out the same whether they are built
    alone or inside a batch of frames.

    - Hit points come from ``origin + t*dir`` (no vertex gathers; fp-identical
      to the surface point up to ULPs, and the 1e-3 light offset dwarfs that).
    - MISS pixels get a guaranteed-miss substitute ray (origin beyond the
      root box's max corner on every axis, direction +x) instead of a junk
      ray from the world origin: the substitute's whole line stays outside
      the root box, so it fails the root record's slabs and retires after one
      pop.  Exact: the shadow mask is ANDed with the hit mask anyway.
    - ``origin_bound`` is a frame-invariant far scale for `occluded`: a bound
      on max|origins| from the scene alone (hit points sit inside the scene
      box + the 1e-3 light offset; miss pixels use miss_o) — the SAME
      arithmetic whichever rays share the occlusion call."""
    dev = o.device
    light = (1.0 / torch.sqrt(torch.tensor(3.0, dtype=torch.float32, device=dev))).expand(3)
    # Kept modest (~2x extent, not +1e6) so occluded()'s far-point scale —
    # and with it the f32 precision of its ``far - eps`` threshold — is
    # unchanged for the real shadow rays.
    base = torch.nan_to_num(bvh.node_aabb_max[0], nan=0.0, posinf=0.0, neginf=0.0)
    miss_o = base + torch.clamp(base.abs().max(), min=1.0)
    miss_d = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float32, device=dev)
    hitm = hits.hit[:, None]
    if substitute:
        p = o + torch.where(hitm, hits.t[:, None], 0.0) * d
        dirs = torch.where(hitm, light[None, :], miss_d[None, :])
        origins = torch.where(hitm, p + light[None, :] * 1e-3, miss_o[None, :])
    else:
        # JUNK variant (``substitute=False``, A/B only): miss pixels trace a
        # real shadow ray from the WORLD ORIGIN (p = 0, inside the scene
        # bounds) toward the light.  Results identical (masked by the hit
        # mask); cost is not.
        p = torch.where(hitm, o + hits.t[:, None] * d, 0.0)
        dirs = light[None, :].expand(p.shape)
        origins = p + dirs * 1e-3
    return origins, dirs, _shadow_origin_bound(scene, miss_o)


def _shadow_mask(scene, bvh, hits, impl, cam, tables=None, substitute=True):
    """Occlusion of every hit pixel toward the light.  Shadow rays inherit the
    primary rays' spatial coherence, so they are reordered into the same
    32×32 tile-major order before tracing."""
    h, w_ = cam.height, cam.width
    tiled = h % 32 == 0 and w_ % 32 == 0
    with span("render.shadow_rays"):
        origins, dirs, origin_bound = shadow_rays(scene, bvh, hits, cam, substitute)
        if tiled:
            origins, dirs = _tile_major(origins, h, w_, 32), _tile_major(dirs, h, w_, 32)
    with span("render.shadow"):
        occ = occluded(
            scene, bvh, origins, dirs, impl=impl, tables=tables,
            origin_bound=origin_bound,
        )
        if tiled:
            occ = _row_major(occ, h, w_, 32)
        return occ & hits.hit


def _render_rgba_impl(
    scene, bvh, cam, tex, tables, impl, shadows=False, shadow_substitute=True
) -> torch.Tensor:
    hits = camera_trace(scene, bvh, cam, impl=impl, tables=tables)
    shadow = (
        _shadow_mask(scene, bvh, hits, impl, cam, tables, shadow_substitute)
        if shadows
        else None
    )
    with span("render.shade"):
        rgba = trace.shade(scene, tex, hits, shadow=shadow)
    return rgba.reshape(cam.height, cam.width, 4)


@torch.no_grad()
def render_rgba(
    scene: Scene,
    bvh: Bvh,
    cam: Camera,
    tex: Texture,
    impl: str = "auto",
    shadows: bool = False,
) -> torch.Tensor:
    """Traced layer as (H, W, 4), row 0 = bottom (Unity UAV orientation)."""
    impl = _resolve(bvh, cam, impl)
    return _render_rgba_impl(
        scene, bvh, cam, tex, _prepared(scene, bvh, impl), impl, shadows
    )


@torch.no_grad()
def render_frame(
    scene: Scene,
    bvh: Bvh,
    cam: Camera,
    tex: Texture,
    background,  # (H, W, 3) or (3,) solid color; tensor or array
    impl: str = "auto",
    shadows: bool = False,
    shadow_substitute: bool = True,
) -> torch.Tensor:
    """Full composited frame (H, W, 4). ``shadows=True`` adds a shadow-ray
    pass toward the fixed light (capability beyond the reference).
    ``shadow_substitute=False`` keeps the junk miss-pixel shadow rays —
    identical output, A/B only."""
    with span("render.frame"):
        impl = _resolve(bvh, cam, impl)
        traced = _render_rgba_impl(
            scene, bvh, cam, tex, _prepared(scene, bvh, impl), impl,
            shadows, shadow_substitute,
        )
        with span("render.compose"):
            bg = torch.as_tensor(background, dtype=torch.float32, device=traced.device)
            return trace.compose(bg.expand(cam.height, cam.width, 3), traced)


@torch.no_grad()
def render_frames(
    scene: Scene,
    bvh: Bvh,
    cams: Camera,
    tex: Texture,
    background,  # (H, W, 3) or (3,) solid color; tensor or array
    impl: str = "auto",
    shadows: bool = False,
) -> torch.Tensor:
    """Batched animation render: (F, H, W, 4) frames from F stacked camera
    poses (`core.camera.stack_cameras`).

    The offline-throughput path the reference's interactive loop cannot
    express (RaytracingMeshDrawer.cs:76-89 renders one frame per Update):
    frames are independent, so the whole animation flattens into ONE ray
    batch — per-frame tile-major rays concatenate to (F*H*W, 3), ONE
    traversal call covers every frame's primary rays and ONE its shadow
    rays, against the frame-invariant table.  Shading and the shadow
    construction are per-ray operations over flat hit arrays, so they run on
    the concatenated batch unchanged.  Bit-identical to F calls of
    `render_frame`.  Width and height must be multiples of 32."""
    f = cams.cam_to_world.shape[0]
    if cams.cam_to_world.ndim != 3:
        raise ValueError("render_frames takes stacked cameras (stack_cameras)")
    h, w = cams.height, cams.width
    if h % 32 or w % 32:
        raise ValueError("batched frames need 32-divisible dims")
    impl = _resolve(bvh, cams, impl)
    tables = _prepared(scene, bvh, impl)

    # An (F*H, W) image in tile-major order IS the per-frame tile-major
    # orders one after another, because H is a whole number of tiles.
    o, d = generate_rays(cams)  # (F, H*W, 3) each
    ot = _tile_major(o.reshape(f * h * w, 3), f * h, w, 32)
    dt = _tile_major(d.reshape(f * h * w, 3), f * h, w, 32)
    hits = trace_rays(scene, bvh, ot, dt, impl=impl, tables=tables)

    shadow = None
    if shadows:
        so, sd, origin_bound = _shadow_rays_from(scene, bvh, hits, ot, dt)
        shadow = occluded(
            scene, bvh, so, sd, impl=impl, tables=tables, origin_bound=origin_bound
        ) & hits.hit
        shadow = _row_major(shadow, f * h, w, 32)
    hits = HitRecord(
        t=_row_major(hits.t, f * h, w, 32),
        tri=_row_major(hits.tri, f * h, w, 32),
        u=_row_major(hits.u, f * h, w, 32),
        v=_row_major(hits.v, f * h, w, 32),
    )
    rgba = trace.shade(scene, tex, hits, shadow=shadow).reshape(f, h, w, 4)
    bg = torch.as_tensor(background, dtype=torch.float32, device=rgba.device)
    return trace.compose(bg.expand(h, w, 3), rgba)


def make_animated_renderer(scene: Scene, bvh: Bvh, cam: Camera, impl: str = "auto"):
    """Per-frame animation renderer: returns ``frame(positions) -> HitRecord``
    which runs deform → refit → record-table update → trace.

    For the BVH4 engines the topology-dependent half of the table pack (entry
    sources + metas, `trace_bvh4._pack_plan4`) is computed ONCE here and
    closed over, with the parent links the refit climbs; each frame repays
    only the refit and the record write (`_apply_plan4`): on the card, one
    launch each (ops/refit_bvh4).  The binary-record engines re-pack their
    whole table from the refitted tree each frame (`trace_bvh2.pack_tables`),
    and ``packet`` / ``perray`` read the scene and tree directly.  The
    reference rebuilds everything each Awake and has no animated path at all
    (RaytracingMeshDrawer.cs:30-84).

    ``positions`` is the (T, 3, 3) deformed corner array (`deform_scene`'s
    input).  Bit-identical to the unfused deform / refit / `render_hits`
    sequence, and on the card to the plain one (``lbvh.refit``,
    `refit_bvh4.write_records_plain`).  The JAX package rejects a
    traced tree here; PyTorch has no traced case, so there is nothing to
    reject."""
    impl = _resolve(bvh, cam, impl)
    plan = None
    with span("tables.pack"):
        # The parent links the refit kernel climbs, made here so that no
        # frame reads back (cached per topology; the BVH4 mask shares them).
        lbvh.topology_links(bvh)
        if impl in ("cuda4", "plain4"):
            mask, new_id, cap4 = trace_bvh4._node_mask_cached(bvh)
            cap4 = max(cap4, 1)
            # Same meta-packing guards as pack_tables4 (idx + leaf<<21 + ax<<22).
            if cap4 >= (1 << 21) or bvh.capacity >= (1 << 21):
                raise ValueError("meta packing needs node and triangle ids < 2^21")
            plan = trace_bvh4._pack_plan4(bvh, mask, new_id, cap4)

    @torch.no_grad()
    def frame(positions: torch.Tensor) -> HitRecord:
        with span("anim.deform"):
            s2 = deform_scene(scene, positions)
        with span("anim.refit"):
            b2 = refit_bvh(s2, bvh)
        with span("anim.tables"):
            tables = None
            if plan is not None:
                tables = trace_bvh4._apply_plan4(s2, b2, *plan)
            elif impl in ("cuda2", "plain2"):
                tables = trace_bvh2.pack_tables(s2, b2)
        with span("anim.trace"):
            return camera_trace(s2, b2, cam, impl=impl, tables=tables)

    return frame


def frame_to_image(frame: torch.Tensor) -> np.ndarray:
    """(H, W, 4) device frame (row 0 = bottom) → top-down numpy for PNG."""
    return frame.detach().cpu().numpy()[::-1]
