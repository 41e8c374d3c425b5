"""BVH / AABB wireframe visualization — the gizmo oracle.

Counterpart of ``unitysimpleraytracing_tpu/utils/visualize.py``, same names.
The reference draws per-triangle and internal-node AABBs as editor wire cubes
(``Assets/_Scripts/RaytracingMeshDrawer.cs:92-116``) as its visual correctness
oracle.  Headless equivalent: project AABB corners through the same pinhole
camera and rasterize wireframe edges over a rendered frame (numpy, host-side —
this is debug tooling, not a render path).

The camera, the boxes and the frame may be tensors on any device or numpy
arrays; each is read to the host once.  The projection runs in the JAX
package's dtypes (the float32 inverse of the float32 camera matrix, float32
points), so the pixels drawn are the JAX package's, bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from unitysimpleraytracing_tpu_torch.core.camera import Camera

_EDGES = [
    (0, 1), (0, 2), (1, 3), (2, 3),  # -x face ring is implicit via bit pairs
    (4, 5), (4, 6), (5, 7), (6, 7),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


class _HostCamera(NamedTuple):
    w2c: np.ndarray      # (4, 4) f32, inverse of the camera-to-world matrix
    tan_half_fov: float
    width: int
    height: int


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _host_camera(cam: Camera | _HostCamera) -> _HostCamera:
    if isinstance(cam, _HostCamera):
        return cam
    c2w = _host(cam.cam_to_world)
    return _HostCamera(np.linalg.inv(c2w), float(cam.tan_half_fov), cam.width, cam.height)


def _corners(bmin: np.ndarray, bmax: np.ndarray) -> np.ndarray:
    """(8, 3) corners; corner i has bit b of i selecting max along axis b."""
    out = np.empty((8, 3), np.float32)
    for i in range(8):
        for ax in range(3):
            out[i, ax] = bmax[ax] if (i >> ax) & 1 else bmin[ax]
    return out


def project_points(cam: Camera, pts: np.ndarray):
    """World points → (pixel_x, pixel_y_bottom_up, in_front) arrays."""
    hc = _host_camera(cam)
    pts = _host(pts)
    p = np.concatenate([pts, np.ones((len(pts), 1), np.float32)], axis=1)
    pc = p @ hc.w2c.T  # camera space, looking down -Z
    in_front = pc[:, 2] < -1e-6
    z = np.where(in_front, -pc[:, 2], 1.0)
    tan = hc.tan_half_fov
    vh = 2.0 * tan                       # near-plane height per unit z
    vw = hc.width * vh / hc.height
    x = (pc[:, 0] / z / vw + 0.5) * hc.width
    y = (pc[:, 1] / z / vh + 0.5) * hc.height
    return x, y, in_front


def draw_line(img: np.ndarray, x0, y0, x1, y1, color) -> None:
    """Clip-free DDA line into (H, W, C); y is bottom-up (UAV convention)."""
    h, w = img.shape[:2]
    steps = int(max(abs(x1 - x0), abs(y1 - y0), 1)) * 2
    ts = np.linspace(0.0, 1.0, steps)
    xs = np.round(x0 + (x1 - x0) * ts).astype(int)
    ys = np.round(y0 + (y1 - y0) * ts).astype(int)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok], : len(color)] = color


def draw_aabbs(
    frame,
    cam: Camera,
    aabb_min,
    aabb_max,
    color=(0.0, 1.0, 0.0),
    max_boxes: int = 4096,
) -> np.ndarray:
    """Overlay AABB wireframes on a bottom-up (H, W, C) float frame.

    Pass ``bvh.node_aabb_min/max[:bvh.num_internal]`` for internal nodes
    (RaytracingMeshDrawer.cs:108-115) or ``scene.aabb_min/max[:scene.count]``
    for per-triangle boxes (:98-105). Returns a numpy copy.
    """
    out = np.array(_host(frame), np.float32, copy=True)
    hc = _host_camera(cam)
    amin = _host(aabb_min[:max_boxes])
    amax = _host(aabb_max[:max_boxes])
    for bmin, bmax in zip(amin, amax):
        cs = _corners(bmin, bmax)
        x, y, vis = project_points(hc, cs)
        for a, b in _EDGES:
            if vis[a] and vis[b]:
                draw_line(out, x[a], y[a], x[b], y[b], color)
    return out
