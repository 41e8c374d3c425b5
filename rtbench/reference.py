"""The plain reference: camera rays, nearest hit, shadow test and shading,
by brute force over every triangle, in plain PyTorch.

It imports neither JAX nor anything of the program under test, and takes
nothing the program made: it works from the benchmark's own mesh arrays
(``rtbench/scenes``), the camera and deformation the benchmark chose, and the
texture (``rtbench/textures``) and background the configuration names.
The program's outputs reach it only to be judged (`rtbench.judge`).

In float64 (``judge=True``) it also says, per ray, where float32 may
rightly decide otherwise ("ambiguous"):

- a primary ray that passes within `edge_eps` (barycentric) of an edge of a
  triangle at least as near as its hit: float32 Möller–Trumbore is not
  watertight, so two float32 walks may let such a ray through a crack, or
  take the neighbour that shares the edge;
- a shadow ray that passes within `SHADOW_EDGE_EPS` of a blocker's edge, or
  meets a blocker within `segment_tol` of the segment's start (a grazing
  triangle whose t float32 rounds across it).

and how far float32 may rightly move the rest: t by ``t_tol``, the
barycentrics u and v by ``uv_tol`` (`UV_RTOL` x the uv condition of the hit
triangle), and so a shaded colour by ``rgb_slack``, the most it changes when u
or v moves by ``uv_tol``.

Lower precisions (``judge=False``, bfloat16) serve as the control: the same
arithmetic, rounded further.
"""
from __future__ import annotations

import math

import numpy as np
import torch

F32_EPS = float(np.finfo(np.float32).eps)
# Möller–Trumbore's acceptance (Raytracing.compute:37-73): |det| >= 1e-8,
# u >= 0, v >= 0, u + v <= 1, and here t > 0 (the camera is outside every
# triangle's box, so the shader's missing t test never matters).
DET_MIN = 1e-8
# A primary ray is ambiguous within max(EDGE_EPS, UV_RTOL x uv condition)
# of an edge: float32 rounds u and v by about eps x |o−a|·|e| / |det|.
EDGE_EPS = 1e-4
UV_RTOL = 4 * F32_EPS
# A shadow ray starts 1e-3 along the light from the hit point, and its
# segment begins SHADOW_T_MIN further on (the program's occlusion query);
# the light is the fixed direction (1, 1, 1) / sqrt(3).
LIGHT = (1.0 / math.sqrt(3.0),) * 3
SHADOW_OFFSET = 1e-3
SHADOW_T_MIN = 4e-3
# The float32 hit point that starts a shadow ray lies about 1e-5 world units
# off float64's; at triangles 0.4 to 0.5 across that is up to 1e-4 in
# barycentric terms, so blockers' edges are given ten times that.
SHADOW_EDGE_EPS = 1e-3
# The program traces shadow rays backward from a far point about 6 scene
# extents away: float32 rounds the segment's start by about eps x far, times
# the blocker's grazing factor max(1, 0.1 / |det|).
SEGMENT_RTOL = 4 * F32_EPS
SEGMENT_ATOL = 2e-3
# The relative bound on t where float64 and float32 take the same triangle:
# 16 eps x |e1|·|e2| / |det| (t is a quotient by det), at least 1e-6.
T_RTOL = 16 * F32_EPS
T_ATOL_REL = 1e-6
# Where float64 and float32 take the same triangle, u and v differ by at most
# UV_RTOL x uv condition, and by at least this much (a hit where the
# condition is near 1).
UV_ATOL = 1e-6
SHADOW_AMBIENT = 0.4


def _cross(a, b):
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Camera-to-world rotation columns (right, up, back) and the eye, in
    float64: the camera looks down its −z axis (OpenGL convention)."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, true_up, -fwd, eye
    return m


def camera_rays(cam: dict, pixels: torch.Tensor, dtype, device):
    """Rays through the centres of ``pixels`` ((P, 2): column, row counted
    from the bottom) on the near plane, as Raytracing.compute:108-126 makes
    them.  ``cam`` holds eye, target, fov_deg, near, width, height."""
    m = torch.as_tensor(look_at(cam["eye"], cam["target"]), dtype=torch.float64)
    w, h, near = cam["width"], cam["height"], float(cam["near"])
    vh = 2.0 * near * math.tan(math.radians(cam["fov_deg"]) / 2)
    vw = w * vh / h
    px = pixels[:, 0].to(torch.float64).cpu()
    py = pixels[:, 1].to(torch.float64).cpu()
    local = torch.stack(
        [-vw / 2 + vw / w * (px + 0.5), -vh / 2 + vh / h * (py + 0.5),
         torch.full_like(px, -near)], dim=-1,
    ).to(device, dtype)
    rot = m[:3, :3].to(device, dtype)
    dirs = local[:, 0:1] * rot[:, 0] + local[:, 1:2] * rot[:, 1] + local[:, 2:3] * rot[:, 2]
    dirs = dirs / torch.sqrt(_dot(dirs, dirs))[:, None]
    origins = m[:3, 3].to(device, dtype).expand_as(dirs)
    return origins, dirs


def _blocks(n_rays, n_tris, device):
    """(ray block, triangle block) sizes: a few million pairs at a time."""
    pairs = (1 << 22) if torch.device(device).type == "cuda" else (1 << 18)
    nb = min(n_tris, pairs)
    rb = max(1, min(n_rays, pairs // nb))
    return rb, nb


def _mt(a, e1, e2, o, d):
    """Möller–Trumbore of rays (Rb, 3) against triangles (Nb, 3): (det, t,
    u, v), each (Rb, Nb)."""
    d3 = d[:, None, :]
    pvec = _cross(d3, e2[None])
    det = _dot(e1[None], pvec)
    tvec = o[:, None, :] - a[None]
    u = _dot(tvec, pvec) / det
    qvec = _cross(tvec, e1[None])
    v = _dot(d3, qvec) / det
    t = _dot(e2[None], qvec) / det
    return det, t, u, v, tvec


class Triangles:
    """Triangle corners (N, 3, 3) on a device, in one dtype, with the edge
    vectors and lengths the tests need."""

    def __init__(self, corners, dtype, device):
        c = torch.as_tensor(np.asarray(corners)).to(device=device, dtype=dtype)
        self.a, self.b, self.c = c[:, 0], c[:, 1], c[:, 2]
        self.e1, self.e2 = self.b - self.a, self.c - self.a
        self.n = c.shape[0]
        self.dtype, self.device = dtype, device
        if dtype == torch.float64:
            l1 = torch.sqrt(_dot(self.e1, self.e1))
            l2 = torch.sqrt(_dot(self.e2, self.e2))
            self.emax, self.eprod = torch.maximum(l1, l2), l1 * l2


def nearest(tris: Triangles, o, d, judge: bool = True) -> dict:
    """Nearest hit of every ray: ``t`` (inf on a miss), ``tri`` (−1), ``u``,
    ``v``; with ``judge`` also ``ambiguous``, and ``t_tol`` and ``uv_tol``
    (the bounds on a float32 t and on float32 u and v where the triangle
    agrees)."""
    r = o.shape[0]
    inf = torch.tensor(float("inf"), dtype=tris.dtype, device=tris.device)
    best_t = torch.full((r,), float("inf"), dtype=tris.dtype, device=tris.device)
    best_j = torch.full((r,), -1, dtype=torch.int64, device=tris.device)
    best_u, best_v = torch.zeros_like(best_t), torch.zeros_like(best_t)
    edge_t = torch.full_like(best_t, float("inf"))
    rb, nb = _blocks(r, tris.n, tris.device)
    for j0 in range(0, tris.n, nb):
        sl = slice(j0, j0 + nb)
        a, e1, e2 = tris.a[sl], tris.e1[sl], tris.e2[sl]
        for i0 in range(0, r, rb):
            rs = slice(i0, i0 + rb)
            det, t, u, v, tvec = _mt(a, e1, e2, o[rs], d[rs])
            ok = (det.abs() >= DET_MIN) & (t > 0)
            margin = torch.minimum(torch.minimum(u, v), 1 - u - v)
            tt = torch.where(ok & (margin >= 0), t, inf)
            tmin, jmin = tt.min(dim=1)
            better = tmin < best_t[rs]
            best_t[rs] = torch.where(better, tmin, best_t[rs])
            best_j[rs] = torch.where(better, jmin + j0, best_j[rs])
            pick = jmin[:, None]
            best_u[rs] = torch.where(better, u.gather(1, pick)[:, 0], best_u[rs])
            best_v[rs] = torch.where(better, v.gather(1, pick)[:, 0], best_v[rs])
            if judge:
                cond = torch.sqrt(_dot(tvec, tvec)) * tris.emax[sl][None] / det.abs()
                eps = torch.clamp(UV_RTOL * cond, min=EDGE_EPS)
                near_edge = ok & (margin.abs() < eps)
                edge_t[rs] = torch.minimum(
                    edge_t[rs], torch.where(near_edge, t, inf).min(dim=1).values)
    out = {"t": best_t, "tri": best_j, "u": best_u, "v": best_v}
    if judge:
        hit = best_j >= 0
        out["ambiguous"] = torch.isfinite(edge_t) & (edge_t <= best_t * (1 + 1e-4))
        j = best_j.clamp(min=0)
        det = _dot(tris.e1[j], _cross(d, tris.e2[j]))
        grazing = tris.eprod[j] / det.abs()
        zero = torch.zeros_like(best_t)
        out["t_tol"] = torch.where(hit, best_t * (T_RTOL * grazing + T_ATOL_REL), zero)
        tvec = o - tris.a[j]
        cond = torch.sqrt(_dot(tvec, tvec)) * tris.emax[j] / det.abs()
        out["uv_tol"] = torch.where(hit, torch.clamp(UV_RTOL * cond, min=UV_ATOL), zero)
    return out


def shadowed(tris: Triangles, o, far: float, judge: bool = True) -> dict:
    """Whether a blocker lies on the segment from ``o`` toward the light,
    beyond `SHADOW_T_MIN`: ``occluded``; with ``judge`` also ``ambiguous``."""
    r = o.shape[0]
    d = torch.tensor(LIGHT, dtype=tris.dtype, device=tris.device).expand(r, 3)
    occ = torch.zeros(r, dtype=torch.bool, device=tris.device)
    amb = torch.zeros_like(occ)
    rb, nb = _blocks(r, tris.n, tris.device)
    for j0 in range(0, tris.n, nb):
        sl = slice(j0, j0 + nb)
        a, e1, e2 = tris.a[sl], tris.e1[sl], tris.e2[sl]
        for i0 in range(0, r, rb):
            rs = slice(i0, i0 + rb)
            det, t, u, v, tvec = _mt(a, e1, e2, o[rs], d[rs])
            ok = det.abs() >= DET_MIN
            margin = torch.minimum(torch.minimum(u, v), 1 - u - v)
            occ[rs] |= (ok & (margin >= 0) & (t > SHADOW_T_MIN)).any(dim=1)
            if judge:
                cond = torch.sqrt(_dot(tvec, tvec)) * tris.emax[sl][None] / det.abs()
                eps = torch.clamp(UV_RTOL * cond, min=SHADOW_EDGE_EPS)
                graze = torch.clamp(0.1 / det.abs(), min=1.0)
                tol = torch.clamp(SEGMENT_RTOL * far * graze, min=SEGMENT_ATOL)
                edge = ok & (margin.abs() < eps) & (t > SHADOW_T_MIN - tol)
                start = ok & (margin > -eps) & ((t - SHADOW_T_MIN).abs() < tol)
                amb[rs] |= (edge | start).any(dim=1)
    return {"occluded": occ, "ambiguous": amb}


def far_scale(tris: Triangles) -> float:
    """About where the program's backward shadow rays start: a few scene
    extents out (it only scales `segment_tol`)."""
    ext = float(torch.stack([tris.a, tris.b, tris.c]).abs().max())
    return 6.0 * (ext + 1.0)


def sample_bilinear(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear, clamp-to-edge sample of ``tex`` ((H, W, C), row 0 at v = 0,
    texel centres at (i + 0.5) / size) at ``uv`` (P, 2): (P, C)."""
    h, w = tex.shape[0], tex.shape[1]
    x, y = uv[:, 0] * w - 0.5, uv[:, 1] * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx = torch.where(x0 < 0, torch.zeros_like(x), x - x0)[:, None]
    fy = torch.where(y0 < 0, torch.zeros_like(y), y - y0)[:, None]
    xi = x0.to(torch.int64).clamp(0, w - 1)
    yi = y0.to(torch.int64).clamp(0, h - 1)
    xj, yj = (xi + 1).clamp(max=w - 1), (yi + 1).clamp(max=h - 1)
    top = tex[yi, xi] * (1 - fx) + tex[yi, xj] * fx
    bot = tex[yj, xi] * (1 - fx) + tex[yj, xj] * fx
    return top * (1 - fy) + bot * fy


class Surface:
    """What shading reads of the hit triangles: corner uvs and normals
    ((N, 3, 2), (N, 3, 3)) and the texture ((H, W, 4), row 0 at v = 0)."""

    def __init__(self, uvs, normals, texture, dtype, device):
        def dev(x):
            return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dtype)

        self.uvs, self.normals, self.texture = dev(uvs), dev(normals), dev(texture)

    def color(self, j, u, v, lit):
        """Lambert ``max(0.4, N·L)`` (0.4 where not ``lit``) times the
        texture at the interpolated uv; normals interpolated, not
        renormalised, as the reference's shader does."""
        w, u, v = (1 - u - v)[:, None], u[:, None], v[:, None]
        c_uv, c_n = self.uvs[j], self.normals[j]
        uv = w * c_uv[:, 0] + u * c_uv[:, 1] + v * c_uv[:, 2]
        n = w * c_n[:, 0] + u * c_n[:, 1] + v * c_n[:, 2]
        light = torch.tensor(LIGHT, dtype=n.dtype, device=n.device)
        lambert = torch.clamp(_dot(n, light), min=SHADOW_AMBIENT)
        lambert = torch.where(lit, lambert, torch.full_like(lambert, SHADOW_AMBIENT))
        return sample_bilinear(self.texture, uv)[:, :3] * lambert[:, None]


def frame_pixels(tris: Triangles, surface: Surface, cam: dict, pixels, background,
                 shadows: bool, judge: bool = True) -> dict:
    """The composited colour (P, 3) of each pixel of ``pixels``: the shaded
    texture (`Surface.color`) where a ray hits, shadowed where a shadow ray
    is blocked, the background where it misses.  With ``judge`` also
    ``ambiguous`` (the primary or the shadow ray may rightly differ) and
    ``rgb_slack`` (P,): how far a colour moves, in its worst channel, when u
    and v move by up to the hit's ``uv_tol``."""
    dt, dev = tris.dtype, tris.device
    o, d = camera_rays(cam, pixels, dt, dev)
    hit = nearest(tris, o, d, judge=judge)
    is_hit = hit["tri"] >= 0
    j = hit["tri"].clamp(min=0)
    lit = torch.ones_like(is_hit)
    amb = hit.get("ambiguous")
    if shadows:
        t = torch.where(is_hit, hit["t"], torch.zeros_like(hit["t"]))
        light = torch.tensor(LIGHT, dtype=dt, device=dev)
        sh = shadowed(tris, o + t[:, None] * d + SHADOW_OFFSET * light,
                      far_scale(tris), judge=judge)
        lit = ~sh["occluded"]
        if judge:
            amb = amb | (is_hit & sh["ambiguous"])
    u, v = hit["u"], hit["v"]
    color = surface.color(j, u, v, lit)
    bg = torch.as_tensor(background, dtype=dt, device=dev)
    rgb = torch.where(is_hit[:, None], color, bg[None])
    out = {"rgb": rgb}
    if judge:
        out["ambiguous"] = amb
        tau = hit["uv_tol"]
        slack = torch.zeros_like(tau)
        for du, dv in ((tau, 0 * tau), (0 * tau, tau)):
            moved = torch.maximum((surface.color(j, u + du, v + dv, lit) - color).abs(),
                                  (surface.color(j, u - du, v - dv, lit) - color).abs())
            slack = slack + moved.amax(dim=1)
        out["rgb_slack"] = torch.where(is_hit, slack, torch.zeros_like(slack))
    return out


def hit_rays(tris: Triangles, cam: dict, pixels, judge: bool = True) -> dict:
    """`nearest` for the primary rays of ``pixels``."""
    o, d = camera_rays(cam, pixels, tris.dtype, tris.device)
    return nearest(tris, o, d, judge=judge)
