"""Pinhole camera and batched primary-ray generation.

Replicates the reference's ray-generation math exactly
(``Assets/_Shaders/Raytracing/Raytracing.compute:108-126``): a near-plane point
per pixel in camera space (OpenGL convention, camera looks down −Z), rotated
into world space by the camera-to-world matrix, then normalized.  The reference
gets ``cameraFov`` as ``tan(fov_deg/2)`` (RaytracingMeshDrawer.cs:80) and the
near distance from Unity's projection params; both are explicit fields here.

Rays are produced as (H*W, 3) tensors on the camera's device; a stack of F
cameras (`stack_cameras`) gives (F, H*W, 3).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from unitysimpleraytracing_tpu_torch.utils.device import resolve_device
from unitysimpleraytracing_tpu_torch.utils.profiling import span


@dataclass(eq=False)
class Camera:
    """One camera, or F stacked cameras of one resolution: the tensor fields
    then carry a leading F axis (`stack_cameras`)."""

    cam_to_world: torch.Tensor  # (4, 4) f32, OpenGL convention (looks down -Z)
    tan_half_fov: torch.Tensor  # scalar f32 = tan(vertical_fov/2)
    near: torch.Tensor          # scalar f32 near-plane distance
    width: int
    height: int


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Camera-to-world matrix with the camera at ``eye`` looking at ``target``.

    OpenGL convention: camera-space −Z axis points at the target.
    """
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    m = np.eye(4)
    m[:3, 0] = right
    m[:3, 1] = true_up
    m[:3, 2] = -fwd
    m[:3, 3] = eye
    return m.astype(np.float32)


def make_camera(
    eye,
    target,
    width: int,
    height: int,
    fov_deg: float = 60.0,
    near: float = 0.3,
    up=(0.0, 1.0, 0.0),
    device=None,
) -> Camera:
    """``device=None`` is the card (raises without one); tests pass "cpu"."""
    device = resolve_device(device)
    with span("camera.make"):
        return Camera(
            cam_to_world=torch.from_numpy(look_at(eye, target, up)).to(device),
            tan_half_fov=torch.tensor(
                math.tan(math.radians(fov_deg) / 2), dtype=torch.float32, device=device
            ),
            near=torch.tensor(near, dtype=torch.float32, device=device),
            width=width,
            height=height,
        )


def stack_cameras(cams) -> Camera:
    """F cameras of one resolution as ONE Camera whose tensor fields carry a
    leading F axis — the input of `render_frames` (the counterpart of
    ``jax.tree.map(lambda *xs: jnp.stack(xs), *cams)``)."""
    cams = list(cams)
    if not cams:
        raise ValueError("no cameras to stack")
    w, h = cams[0].width, cams[0].height
    for c in cams:
        if (c.width, c.height) != (w, h):
            raise ValueError("stacked cameras must share one resolution")
        if c.cam_to_world.ndim != 2:
            raise ValueError("stack_cameras takes single cameras")
    return Camera(
        cam_to_world=torch.stack([c.cam_to_world for c in cams]),
        tan_half_fov=torch.stack([c.tan_half_fov for c in cams]),
        near=torch.stack([c.near for c in cams]),
        width=w,
        height=h,
    )


def generate_rays(cam: Camera) -> tuple[torch.Tensor, torch.Tensor]:
    """All primary rays for the frame: origins (R,3) and unit directions (R,3);
    (F,R,3) each for F stacked cameras, frame f bit-identical to the rays of
    camera f alone (every operation below is elementwise).

    Pixel (px, py) maps exactly like Raytracing.compute:108-126:
    ``py`` is the bottom-up row index (Unity UAV convention), ray passes
    through the pixel center on the near plane.  R = width*height, row-major
    with py outer so that ``rays[py*W + px]`` is pixel (px, py).

    The camera rotation is written as three broadcast multiply-adds rather
    than a matrix product, so no BLAS or reduced-precision path can touch it
    and the CPU and the card compute the same float32 operations.
    """
    w, h = cam.width, cam.height
    dev = cam.cam_to_world.device
    lead = cam.cam_to_world.shape[:-2]               # () or (F,)
    near = cam.near.reshape(*lead, 1)
    vh = 2.0 * near * cam.tan_half_fov.reshape(*lead, 1)  # near-plane height
    vw = w * vh / h                                  # near-plane width
    px = torch.arange(w, dtype=torch.float32, device=dev)
    py = torch.arange(h, dtype=torch.float32, device=dev)
    x = -vw / 2 + vw / w * (px + 0.5)                # (..., W)
    y = -vh / 2 + vh / h * (py + 0.5)                # (..., H)
    xg = x[..., None, :].expand(*lead, h, w).reshape(*lead, h * w)
    yg = y[..., :, None].expand(*lead, h, w).reshape(*lead, h * w)
    zg = (-near).expand(*lead, h * w)
    rot = cam.cam_to_world[..., :3, :3]
    # dirs = dirs_cam @ rot.T (w=0 transform), component by component.
    comps = [
        xg * rot[..., j, 0, None] + yg * rot[..., j, 1, None] + zg * rot[..., j, 2, None]
        for j in range(3)
    ]
    norm = torch.sqrt(comps[0] * comps[0] + comps[1] * comps[1] + comps[2] * comps[2])
    dirs = torch.stack([c / norm for c in comps], dim=-1)
    origin = cam.cam_to_world[..., :3, 3]
    origins = origin[..., None, :].expand(*lead, h * w, 3).contiguous()
    return origins, dirs
