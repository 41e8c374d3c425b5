"""Ray-box (slab) and ray-triangle (Möller–Trumbore) tests, batched.

Bit-parity targets:

- Slab test (``Raytracing.compute:75-87``): acceptance is exactly
  ``tmax > tmin && tmax > 0`` — no near-plane clip, no ordering of children.
  HLSL ``min``/``max`` follow D3D semantics (NaN in one operand returns the
  other operand); ``torch.minimum``/``maximum`` propagate NaN, while
  ``torch.fmin``/``fmax`` implement exactly the D3D rule.  NaNs arise when a
  zero direction component (inv_dir=±inf) meets a coincident slab (0·inf).
- Möller–Trumbore (``Raytracing.compute:37-73``): rejects ``|det| < 1e-8``,
  ``u∉[0,1]``, ``v<0 or u+v>1`` — and accepts *negative* t exactly like the
  reference (no t>0 test; the triangle-AABB pre-test usually culls behind-ray
  hits, but not when the origin is inside the box).

Three-component sums are written out term by term in one fixed order (never
``sum(dim=-1)``), so the CPU and the card do the same float32 operations.
"""
from __future__ import annotations

import torch

from unitysimpleraytracing_tpu_torch import constants as C


def d3d_min(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """HLSL min: if one operand is NaN, returns the other."""
    return torch.fmin(a, b)


def d3d_max(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.fmax(a, b)


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3)·(..., 3) as ``(a0*b0 + a1*b1) + a2*b2``."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def ray_box(
    box_min: torch.Tensor,  # (..., 3)
    box_max: torch.Tensor,  # (..., 3)
    origin: torch.Tensor,   # (..., 3)
    inv_dir: torch.Tensor,  # (..., 3)
) -> torch.Tensor:
    """Slab test; returns bool (...). Matches Raytracing.compute:75-87."""
    t1 = (box_min - origin) * inv_dir
    t2 = (box_max - origin) * inv_dir
    tmin3 = d3d_min(t1, t2)
    tmax3 = d3d_max(t1, t2)
    tmin = d3d_max(tmin3[..., 0], d3d_max(tmin3[..., 1], tmin3[..., 2]))
    tmax = d3d_min(tmax3[..., 0], d3d_min(tmax3[..., 1], tmax3[..., 2]))
    return (tmax > tmin) & (tmax > 0)


def ray_triangle(
    origin: torch.Tensor,  # (..., 3)
    direction: torch.Tensor,  # (..., 3)
    v0: torch.Tensor,
    v1: torch.Tensor,
    v2: torch.Tensor,
):
    """Möller–Trumbore. Returns (t, u, v) with t = MAX_FLOAT on reject.

    Matches Raytracing.compute:37-73 including NaN fall-through: a NaN
    intermediate fails every reject test but also fails the final
    ``t < best`` comparison, so it never becomes a hit.
    """
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = cross3(direction, e2)
    det = dot3(e1, pvec)
    reject_det = (det < 1e-8) & (det > -1e-8)

    inv_det = 1.0 / det
    tvec = origin - v0
    u = dot3(tvec, pvec) * inv_det
    reject_u = (u < 0) | (u > 1)

    qvec = cross3(tvec, e1)
    v = dot3(direction, qvec) * inv_det
    reject_v = (v < 0) | (u + v > 1)

    t = dot3(e2, qvec) * inv_det
    reject = reject_det | reject_u | reject_v
    t = torch.where(reject, C.MAX_FLOAT, t)
    return t, u, v
