"""Frame rendering: camera rays → traversal → shading → composition.

The reference's per-frame path (``RaytracingMeshDrawer.cs:76-89``) dispatches
the traversal kernel into an RGBA16F UAV and composites in ``OnRenderImage``.
Here `render_frame` produces the final (H, W, 4) image on the scene's device;
`render_rgba` returns just the traced layer (the UAV analog).  Batched and
animated frames (``render_frames``, ``make_animated_renderer``) are not ported
yet (ROADMAP queue 1, leftovers).
"""
from __future__ import annotations

import numpy as np
import torch

from unitysimpleraytracing_tpu_torch.core.camera import Camera, generate_rays
from unitysimpleraytracing_tpu_torch.core.texture import Texture
from unitysimpleraytracing_tpu_torch.core.types import Bvh, HitRecord, Scene
from unitysimpleraytracing_tpu_torch.ops import trace, trace_bvh4
from unitysimpleraytracing_tpu_torch.ops.dispatch import (
    _row_major,
    _tile_major,
    camera_trace,
    occluded,
    resolve_impl,
)


def _prepared(scene: Scene, bvh: Bvh, impl: str):
    """The record table, packed once per (scene, bvh) — the Awake/Update
    split of the reference (tables are frame-invariant,
    RaytracingMeshDrawer.cs:30-84)."""
    if impl in ("cuda4", "plain4"):
        return trace_bvh4.prepare_tables4(scene, bvh)
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
    """Shadow rays toward the reference's fixed directional light (1,1,1), in
    row-major pixel order: ``(origins, dirs, origin_bound)``.  Rays start at
    the hit point, offset along the light to avoid self-intersection.

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
    o, d = generate_rays(cam)
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
    origins, dirs, origin_bound = shadow_rays(scene, bvh, hits, cam, substitute)
    h, w_ = cam.height, cam.width
    if h % 32 == 0 and w_ % 32 == 0:
        occ = occluded(
            scene, bvh,
            _tile_major(origins, h, w_, 32), _tile_major(dirs, h, w_, 32),
            impl=impl, tables=tables, origin_bound=origin_bound,
        )
        return _row_major(occ, h, w_, 32) & hits.hit
    return occluded(
        scene, bvh, origins, dirs, impl=impl, tables=tables,
        origin_bound=origin_bound,
    ) & hits.hit


def _render_rgba_impl(
    scene, bvh, cam, tex, tables, impl, shadows=False, shadow_substitute=True
) -> torch.Tensor:
    hits = camera_trace(scene, bvh, cam, impl=impl, tables=tables)
    shadow = (
        _shadow_mask(scene, bvh, hits, impl, cam, tables, shadow_substitute)
        if shadows
        else None
    )
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
    impl = _resolve(bvh, cam, impl)
    traced = _render_rgba_impl(
        scene, bvh, cam, tex, _prepared(scene, bvh, impl), impl,
        shadows, shadow_substitute,
    )
    bg = torch.as_tensor(background, dtype=torch.float32, device=traced.device)
    bg = bg.expand(cam.height, cam.width, 3)
    return trace.compose(bg, traced)


def frame_to_image(frame: torch.Tensor) -> np.ndarray:
    """(H, W, 4) device frame (row 0 = bottom) → top-down numpy for PNG."""
    return frame.detach().cpu().numpy()[::-1]
