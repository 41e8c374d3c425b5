"""The parity contract as assertion helpers (numpy only).

Used by the port's tests (JAX package vs port) and by ``chip_smoke.py``
(kernel vs plain version, frames vs goldens).  Every helper takes anything
``np.asarray`` accepts.

The contract (README "Parity contract"): identical hit masks; hit triangle
ids identical except at exact-t ties; t bounded relatively; build arrays bit
for bit; frames within ±2/255 on all but 0.2 % of pixels.

At the sizes people render, the contract needs one more rule (the crack rule,
`assert_hit_parity_at_scale`): float32 Möller–Trumbore is not watertight, so
two substrates that round differently let different rays through the crack
along an edge two triangles share.  Such a ray may differ, and only such a
ray: float64 decides what it should hit.
"""
from __future__ import annotations

import hashlib
from types import SimpleNamespace

import numpy as np

from unitysimpleraytracing_tpu_torch import constants as C

MAX_FLOAT = np.float32(3.4028234663852886e38)
# Relative bound on t between two traversal substrates, and the definition of
# an "exact-t tie" for triangle-id flips on shared edges.
_TIE_RTOL = 4e-6
# The crack rule's bounds.  Per ray, float64's hit must lie within
# max(EDGE_EPS, UV_ATOL_AT_SCALE x `uv_condition`) (barycentric) of a shared
# edge for two float32 answers to differ on it.  The mask cracks seen lie
# 1.6e-6 to 3.8e-5 from one (config 2: 4.73e-6); rays seen from far or at a
# graze get float32's error in u, v, about eps x `uv_condition`.
EDGE_EPS = 1e-4
# u, v bound at the bench's sizes, times `uv_condition`: 4 float32 eps (the
# sides differ by up to 1.66 of it at config 2, each side and float64 by 1.12).
UV_ATOL_AT_SCALE = 4 * float(np.finfo(np.float32).eps)
# The occlusion rule's bound on the segment's end, relative to far − eps and
# times `grazing_factor`: 4 float32 eps (t is a quotient by det, so float32
# rounds a grazing triangle's t by about eps x `grazing_factor`; the flips
# at config 3's segment ends need up to 1.10 of it, at grazing factors
# 143–243).
SEGMENT_END_RTOL = 4 * float(np.finfo(np.float32).eps)
# The shadow segment ends this far short of the far point: the default
# ``eps`` of `ops.dispatch.occluded`, which every shadow pass traces with.
SHADOW_EPS = 4e-3


def _hit_fields(h):
    return (np.asarray(h.t), np.asarray(h.tri), np.asarray(h.u), np.asarray(h.v))


def grazing_factor(a, b, c, dirs, tri, det_floor: float = 0.1) -> np.ndarray:
    """Per-ray conditioning of the barycentrics of triangle ``tri[r]`` under
    ray direction ``dirs[r]``: ``max(1, det_floor / |det|)`` with
    ``det = e1·(d×e2)``.

    u and v are quotients by det.  Two substrates that round their numerators
    differently by an ulp (a fused multiply-add on one side) differ in u, v by
    that ulp times ``|o−a|·|d×e2| / |det|``: rays that graze a triangle
    (small |det|) amplify it.  Scaling the u/v bound by this factor keeps the
    bound tight for ordinary rays and honest for grazing ones."""
    a, b, c, dirs, tri = (np.asarray(x) for x in (a, b, c, dirs, tri))
    e1, e2 = b[tri] - a[tri], c[tri] - a[tri]
    det = np.einsum("ij,ij->i", e1.astype(np.float64), np.cross(dirs, e2).astype(np.float64))
    return np.maximum(1.0, det_floor / np.maximum(np.abs(det), 1e-30))


def uv_condition(a, b, c, o, d, tri) -> np.ndarray:
    """Per-ray float32 conditioning of u and v of triangle ``tri[r]`` on ray
    ``r`` (``o``, ``d``: the rays): ``|o−a|·max(|e1|, |e2|) / |det|``.

    u and v are quotients by det of dot products as large as ``|o−a|·|e|``,
    so a rounding of either substrate, or an ulp of difference between their
    rays, moves them by about float32's eps times this.  `grazing_factor`
    keeps only the ``1/|det|``; that serves scenes seen from close by, not a
    camera 100 units from triangles 0.4 across, where this factor runs from
    about 200 to 1e5 (config 2)."""
    tri = np.asarray(tri)
    a, b, c = (np.asarray(x)[tri].astype(np.float64) for x in (a, b, c))
    o, d = (np.asarray(x).astype(np.float64) for x in (o, d))
    e1, e2 = b - a, c - a
    det = np.einsum("ij,ij->i", e1, np.cross(d, e2))
    edge = np.maximum(np.linalg.norm(e1, axis=1), np.linalg.norm(e2, axis=1))
    return np.linalg.norm(o - a, axis=1) * edge / np.maximum(np.abs(det), 1e-30)


def assert_hit_parity(got, ref, uv_atol: float | None = None, exact: bool = False,
                      uv_scale=None):
    """Hit-record parity of ``got`` against ``ref`` (objects with t/tri/u/v).

    Identical hit masks; ``t`` within ``_TIE_RTOL`` on hits; every ``tri``
    mismatch is an exact-t tie.  ``uv_atol`` additionally bounds u and v where
    ``tri`` agrees, times the per-ray ``uv_scale`` (see `grazing_factor`)
    where given.  ``exact=True`` demands bit-identical t, u, v where ``tri``
    agrees (two versions of the same arithmetic).  Returns a dict of counts
    and maximum differences."""
    t_g, tri_g, u_g, v_g = _hit_fields(got)
    t_r, tri_r, u_r, v_r = _hit_fields(ref)
    hit_g, hit_r = t_g != MAX_FLOAT, t_r != MAX_FLOAT
    np.testing.assert_array_equal(hit_g, hit_r, err_msg="hit masks differ")
    hit = hit_r
    np.testing.assert_allclose(t_g[hit], t_r[hit], rtol=_TIE_RTOL)
    mism = (tri_g != tri_r) & hit
    tied = np.abs(t_g - t_r) <= _TIE_RTOL * np.abs(t_r)
    assert not np.any(mism & ~tied), "hit-id mismatch that is not an exact-t tie"
    same = hit & ~mism
    stats = {
        "rays": int(hit.size),
        "hits": int(hit.sum()),
        "tri_ties": int(mism.sum()),
        "max_abs_dt": float(np.max(np.abs(t_g[same] - t_r[same]), initial=0.0)),
        "max_abs_duv": float(
            max(
                np.max(np.abs(u_g[same] - u_r[same]), initial=0.0),
                np.max(np.abs(v_g[same] - v_r[same]), initial=0.0),
            )
        ),
    }
    if exact:
        for name, g, r in (("t", t_g, t_r), ("u", u_g, u_r), ("v", v_g, v_r)):
            assert_bits_equal(g[same], r[same], name)
        miss = ~hit
        assert_bits_equal(tri_g[miss], tri_r[miss], "tri on misses")
    if uv_atol is not None:
        bound = uv_atol * (1.0 if uv_scale is None else np.asarray(uv_scale)[same])
        for name, g, r in (("u", u_g, u_r), ("v", v_g, v_r)):
            over = np.abs(g[same] - r[same]) > bound
            assert not over.any(), (
                f"{name}: {int(over.sum())} rays beyond atol {uv_atol} "
                f"(max diff {np.abs(g[same] - r[same]).max()})"
            )
    return stats


def _mt64(a, b, c, o, d):
    """Float64 Möller–Trumbore as Raytracing.compute:37-73 orders it, no
    acceptance test: (det, t, u, v), broadcast over the leading axes."""
    e1, e2 = b - a, c - a
    pvec = np.cross(d, e2)
    det = np.sum(e1 * pvec, axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_det = 1.0 / det
        tvec = o - a
        u = np.sum(tvec * pvec, axis=-1) * inv_det
        qvec = np.cross(tvec, e1)
        v = np.sum(d * qvec, axis=-1) * inv_det
        t = np.sum(e2 * qvec, axis=-1) * inv_det
    return det, t, u, v


def _accept64(det, t, u, v):
    """The reference's acceptance of a Möller–Trumbore answer: ``det`` outside
    (−1e-8, 1e-8), ``u ≥ 0``, ``v ≥ 0``, ``u + v ≤ 1``, ``t > 0``."""
    return ~((det > -1e-8) & (det < 1e-8)) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0)


# u = 0 lies on edge a–c, v = 0 on a–b, 1 − u − v = 0 on b–c.
_EDGES = ((0, 2), (0, 1), (1, 2))


def _f64_rows(a, b, c, o, d, rows):
    """`f64_nearest` one row at a time, lazily: yields (tri, t, u, v,
    edge_distance, edge) per row, tri −1 on a miss."""
    verts = [np.asarray(x) for x in (a, b, c)]
    a64, b64, c64 = (x.astype(np.float64) for x in verts)
    o, d = np.asarray(o), np.asarray(d)
    for r in np.asarray(rows, np.int64).reshape(-1):
        det, t, u, v = _mt64(a64, b64, c64, o[r].astype(np.float64), d[r].astype(np.float64))
        ok = _accept64(det, t, u, v)
        if not ok.any():
            yield -1, np.inf, np.nan, np.nan, np.inf, np.zeros((2, 3), verts[0].dtype)
            continue
        cand = np.flatnonzero(ok)
        j = int(cand[np.argmin(t[cand])])  # first of equal minima: strict < by id
        bary = (u[j], v[j], 1.0 - u[j] - v[j])
        e = int(np.argmin(bary))
        yield j, t[j], u[j], v[j], bary[e], np.stack(
            (verts[_EDGES[e][0]][j], verts[_EDGES[e][1]][j]))


def f64_nearest(a, b, c, o, d, rows) -> dict:
    """Float64 nearest hit of rays ``o[r]``, ``d[r]`` for each ``r`` in
    ``rows``, over every triangle of ``a``, ``b``, ``c`` ((N, 3) each: the
    real triangles only).  Geometry, not traversal: no box pre-test.  The
    reference's acceptance: reject ``det`` in (−1e-8, 1e-8); accept
    ``u ≥ 0``, ``v ≥ 0``, ``u + v ≤ 1``, ``t > 0``; nearest by strict ``<``
    in triangle-id order.

    Returns arrays over ``rows``: ``tri`` (−1 on a miss), ``t`` (inf on a
    miss), ``u``, ``v``, ``edge_distance`` (``min(u, v, 1−u−v)``, the
    barycentric distance to the nearest edge) and ``edge`` ((K, 2, 3), that
    edge's two vertices as given, bit for bit)."""
    keys = ("tri", "t", "u", "v", "edge_distance", "edge")
    cols = list(zip(*_f64_rows(a, b, c, o, d, rows))) or [[]] * len(keys)
    out = {k: np.asarray(col) for k, col in zip(keys, cols)}
    out["tri"] = out["tri"].astype(np.int64)
    out["edge"] = out["edge"].reshape(-1, 2, 3).astype(np.asarray(a).dtype)
    return out


def f64_on_triangle(a, b, c, o, d, tri):
    """Float64 (t, u, v) of triangle ``tri[r]`` on ray ``r``, for every ray,
    with no acceptance test: what a reference that stores only hit ids had
    for t, u and v."""
    tri = np.asarray(tri)
    a, b, c = (np.asarray(x)[tri].astype(np.float64) for x in (a, b, c))
    _, t, u, v = _mt64(a, b, c, *(np.asarray(x).astype(np.float64) for x in (o, d)))
    return t, u, v


def _with_edge(a, b, c, edge) -> np.ndarray:
    """Mask of the triangles that have both vertices of ``edge`` among their
    own, bit for bit (none for a degenerate edge)."""
    def bits(x):
        x = np.ascontiguousarray(x)
        return x.view(np.dtype(f"u{x.dtype.itemsize}"))

    p, q = bits(edge[0]), bits(edge[1])
    verts = [bits(x) for x in (a, b, c)]
    has_p = np.logical_or.reduce([(x == p).all(axis=1) for x in verts])
    has_q = np.logical_or.reduce([(x == q).all(axis=1) for x in verts])
    return has_p & has_q & (not np.array_equal(p, q))


def assert_hit_parity_at_scale(got, ref, a, b, c, o, d) -> dict:
    """`assert_hit_parity` with the crack rule, for rays traced at the sizes
    people render (``a``, ``b``, ``c``: the real triangles, (N, 3) each;
    ``o``, ``d``: the rays, in the order of ``got`` and ``ref``).

    A ray is *divergent* where the hit masks differ, or where both sides hit
    triangles of different ids whose t differ by more than ``_TIE_RTOL``.
    Every other ray is held to `assert_hit_parity` as it stands, with u and v
    within ``UV_ATOL_AT_SCALE`` times `uv_condition` of ``ref``'s triangle.
    Every divergent ray must meet all of:

    (a) float64 Möller–Trumbore over every triangle (`f64_nearest`) hits it;
    (b) float64's hit lies within ``max(EDGE_EPS, UV_ATOL_AT_SCALE ×
        uv_condition)`` (barycentric; `uv_condition` of float64's triangle on
        the ray) of an edge that another real triangle shares, both endpoints
        bit-equal: float32 sees a ray inside or outside by u and v, which
        carry about that error, so a ray seen from far or at a graze can fall
        through a wider crack;
    (c) at least one side equals float64's answer in its mask and its id, up
        to an exact-t tie across that edge: a side that hit the triangle on
        the edge's other side, whose float64 t lies within ``_TIE_RTOL`` of
        float64's, agrees with it as `assert_hit_parity` lets two sides
        agree at a tie (listed in ``across_edge``).

    Divergent rays are checked one by one, each with its own float64 pass,
    so the first that breaks the rule raises at once.

    Where both sides hit the same triangle, t is held within ``_TIE_RTOL``
    times `grazing_factor` of ``ref``'s triangle on the ray: t = e2·q / det
    is a quotient by det, as u and v are, so a grazing ray amplifies an ulp
    of difference in its rays or its numerators.  Such a ray beyond the
    fixed bound is held to the scaled one, and to the u/v bound, and listed
    in ``grazing_t``.

    Returns `assert_hit_parity`'s counts over the other rays, plus
    ``divergent`` (the rays' indices), ``tie_rays`` (the rays whose ids
    differ at an exact-t tie), ``agrees`` (``"got"`` or ``"ref"``
    per divergent ray: the side float64 sides with), ``f64_tri``,
    ``edge_distance`` and ``edge_bound`` per divergent ray,
    ``max_edge_distance``, ``across_edge`` and ``grazing_t``."""
    t_g, tri_g, u_g, v_g = _hit_fields(got)
    t_r, tri_r, u_r, v_r = _hit_fields(ref)
    o, d = np.asarray(o), np.asarray(d)
    hit_g, hit_r = t_g != MAX_FLOAT, t_r != MAX_FLOAT
    uv_scale = uv_condition(a, b, c, o, d, tri_r)
    apart = np.abs(t_g.astype(np.float64) - t_r) > _TIE_RTOL * np.abs(t_r.astype(np.float64))
    divergent = (hit_g != hit_r) | (hit_g & hit_r & (tri_g != tri_r) & apart)
    rows = np.flatnonzero(divergent)
    keep = ~divergent
    grazing = hit_g & hit_r & (tri_g == tri_r) & apart
    scale = grazing_factor(a, b, c, np.asarray(d)[grazing], tri_r[grazing])
    dt = np.abs(t_g[grazing].astype(np.float64) - t_r[grazing])
    over = dt > _TIE_RTOL * scale * np.abs(t_r[grazing].astype(np.float64))
    assert not over.any(), (
        f"t beyond {_TIE_RTOL} x grazing factor on rays {np.flatnonzero(grazing)[over]}")
    for name, g, r in (("u", u_g, u_r), ("v", v_g, v_r)):
        assert not (np.abs(g[grazing] - r[grazing])
                    > UV_ATOL_AT_SCALE * uv_scale[grazing]).any(), (
            f"{name} beyond UV_ATOL_AT_SCALE x uv_condition on a grazing ray")
    keep &= ~grazing

    def kept(t, tri, u, v):
        return SimpleNamespace(t=t[keep], tri=tri[keep], u=u[keep], v=v[keep])

    stats = assert_hit_parity(
        kept(t_g, tri_g, u_g, v_g), kept(t_r, tri_r, u_r, v_r), uv_atol=UV_ATOL_AT_SCALE,
        uv_scale=uv_scale[keep])
    agrees, across_edge, f64_tri, edge_distance, edge_bound = [], [], [], [], []
    for r, (j, t64, _, _, dist, edge) in zip(rows, _f64_rows(a, b, c, o, d, rows)):
        assert j >= 0, f"ray {r}: the sides differ and float64 misses it"
        bound = max(EDGE_EPS, UV_ATOL_AT_SCALE * float(
            uv_condition(a, b, c, o[r:r + 1], d[r:r + 1], [j])[0]))
        assert dist <= bound, (
            f"ray {r}: the sides differ {dist:.3g} from triangle {j}'s nearest edge, "
            f"beyond max(EDGE_EPS, UV_ATOL_AT_SCALE x uv_condition) = {bound:.3g}")
        sharing = _with_edge(a, b, c, edge)
        sharing[j] = False
        assert sharing.any(), (
            f"ray {r}: the sides differ near an edge of triangle {j} that no other "
            f"triangle shares")
        sides = {"got": int(tri_g[r]) if hit_g[r] else None,
                 "ref": int(tri_r[r]) if hit_r[r] else None}
        exact = [k for k, s in sides.items() if s == j]
        tied = [k for k, s in sides.items() if s is not None and sharing[s] and abs(
            f64_on_triangle(a, b, c, o[r], d[r], s)[0] - t64) <= _TIE_RTOL * t64]
        assert exact or tied, (
            f"ray {r}: neither side agrees with float64's hit on triangle {j} "
            f"(got {sides['got']}, ref {sides['ref']}; None is a miss)")
        agrees.append((exact or tied)[0])
        if not exact:
            across_edge.append(int(r))
        f64_tri.append(j)
        edge_distance.append(float(dist))
        edge_bound.append(bound)
    tie_rays = np.flatnonzero(hit_g & hit_r & (tri_g != tri_r) & ~apart)
    stats.update(
        divergent=[int(r) for r in rows], agrees=agrees, f64_tri=f64_tri,
        tie_rays=[int(r) for r in tie_rays],
        max_edge_distance=max(edge_distance, default=0.0), edge_distance=edge_distance,
        edge_bound=edge_bound, across_edge=across_edge,
        grazing_t=[int(r) for r in np.flatnonzero(grazing)],
    )
    return stats


def _occlusion_limits(a, b, c, origin_bound):
    """``(far, far − SHADOW_EPS)`` in float32 as `occluded` computes them: ``far =
    4·ext + origin_bound + 1`` with ``ext`` the largest coordinate of the
    triangles' inflated boxes (a scene's padding slots add only ±inflation)."""
    f32 = np.float32
    verts = [np.asarray(x, f32) for x in (a, b, c)]
    infl = f32(C.AABB_INFLATION)
    lo = np.minimum(np.minimum(verts[0], verts[1]), verts[2]) - infl
    hi = np.maximum(np.maximum(verts[0], verts[1]), verts[2]) + infl
    ext = max(np.abs(lo).max(), np.abs(hi).max())
    far = f32(4.0) * ext + f32(origin_bound) + f32(1.0)
    return far, far - f32(SHADOW_EPS)


def _shadow_ray64(verts, verts64, o, d, far, limit):
    """Float64 of one shadow ray (``o``, ``d``: float32 (3,)) traced as
    `occluded` traces it, from ``o + d·far`` (float32, as both packages
    form it) along ``−d``.  Returns a per-ray view: ``blockers`` (the
    triangles float64 accepts strictly inside the segment, t < far − eps)
    and what `_explain_flip` needs."""
    bo = o + d * far
    bo64, bd64 = bo.astype(np.float64), -d.astype(np.float64)
    det, t, u, v = _mt64(*verts64, bo64, bd64)
    ok = _accept64(det, t, u, v)
    lim = float(limit)
    return SimpleNamespace(verts=verts, bo=bo, bd=-d, det=det, t=t, u=u, v=v, ok=ok,
                           lim=lim, blockers=np.flatnonzero(ok & (t < lim)))


def _edge_bound(ray, j):
    """The crack rule's per-ray edge bound for triangle ``j`` on ``ray``."""
    a, b, c = ray.verts
    return max(EDGE_EPS, UV_ATOL_AT_SCALE * float(
        uv_condition(a, b, c, ray.bo[None], ray.bd[None], [j])[0]))


def _end_bound(ray, j):
    """How far from ``far − eps`` (in t) float32 may see triangle ``j``'s t
    on ``ray``: ``SEGMENT_END_RTOL`` x `grazing_factor` x ``far − eps``."""
    a, b, c = ray.verts
    g = float(grazing_factor(a, b, c, ray.bd[None], [j])[0])
    return SEGMENT_END_RTOL * g * ray.lim


def _shared_edge(ray, j, bary) -> bool:
    """Whether the edge of triangle ``j`` with the smallest barycentric in
    ``bary`` (u, v, 1−u−v) is one another real triangle shares."""
    e = _EDGES[int(np.argmin(bary))]
    edge = np.stack([ray.verts[e[0]][j], ray.verts[e[1]][j]])
    sharing = _with_edge(*ray.verts, edge)
    sharing[j] = False
    return bool(sharing.any())


def _explain_flip(ray, r, side):
    """Why float32 may see ``ray`` (ray index ``r``) otherwise than float64
    does, or AssertionError.  Returns ``("edge_distance", d)`` or
    ``("near_threshold", d)`` (``d``: the largest barycentric distance to
    a shared edge, or of t to ``far − eps``, that the flip needed)."""
    if len(ray.blockers):
        # float64 occluded, ``side`` clear: float32 missed every blocker, so
        # each lies in a crack along a shared edge or at the segment's end.
        worst = {"edge_distance": [], "near_threshold": []}
        for j in ray.blockers:
            bary = np.array([ray.u[j], ray.v[j], 1.0 - ray.u[j] - ray.v[j]])
            if abs(ray.t[j] - ray.lim) <= _end_bound(ray, j):
                worst["near_threshold"].append(abs(ray.t[j] - ray.lim) / ray.lim)
                continue
            dist, bound = float(bary.min()), _edge_bound(ray, j)
            assert dist <= bound and _shared_edge(ray, j, bary), (
                f"shadow ray {r}: {side} sees no blocker, but float64 finds triangle "
                f"{j} at t {ray.t[j]:.9g} (segment ends {ray.lim:.9g}), {dist:.3g} from "
                f"its nearest edge (bound {bound:.3g}), not in a crack along an edge "
                f"another triangle shares")
            worst["edge_distance"].append(dist)
        kind = "edge_distance" if worst["edge_distance"] else "near_threshold"
        return kind, float(max(worst[kind]))
    # float64 clear, ``side`` occluded: some triangle lies within the edge
    # bound outside an edge another triangle shares, inside the segment, or
    # float64 accepts one just beyond the segment's end.
    bary = np.stack([ray.u, ray.v, 1.0 - ray.u - ray.v])
    outside = -bary.min(axis=0)
    live = ~((ray.det > -1e-8) & (ray.det < 1e-8)) & (ray.t > 0)
    near_end = np.flatnonzero(ray.ok & (ray.t >= ray.lim))
    for j in near_end[np.argsort(ray.t[near_end])]:
        if ray.t[j] - ray.lim <= _end_bound(ray, j):
            return "near_threshold", float((ray.t[j] - ray.lim) / ray.lim)
    cand = np.flatnonzero(live & (ray.t < ray.lim) & (outside > 0))
    n = len(cand)
    bound = np.maximum(EDGE_EPS, UV_ATOL_AT_SCALE * uv_condition(
        *ray.verts, np.broadcast_to(ray.bo, (n, 3)), np.broadcast_to(ray.bd, (n, 3)), cand))
    near = cand[outside[cand] <= bound]
    for j in near[np.argsort(outside[near])]:
        if _shared_edge(ray, j, bary[:, j]):
            return "edge_distance", float(outside[j])
    raise AssertionError(
        f"shadow ray {r}: {side} sees a blocker, but float64 finds none inside the segment, "
        f"none within the edge bound outside an edge another triangle shares, and none "
        f"within the rounding bound beyond its end")


def float64_occlusion(a, b, c, o, d, origin_bound) -> dict:
    """Float64 of one shadow ray (``o``, ``d``: (3,)) as the occlusion rule
    sees it: ``occluded``, ``limit`` (far − eps) and per blocker ``tri``,
    ``t``, ``edge_distance`` (barycentric, to its nearest edge),
    ``edge_bound`` (the crack rule's bound there) and ``shared`` (whether
    another real triangle has that edge).  For a ray the rule refuses and a
    caller pins, so that the pin says why."""
    verts = [np.asarray(x) for x in (a, b, c)]
    far, limit = _occlusion_limits(a, b, c, origin_bound)
    ray = _shadow_ray64(verts, [x.astype(np.float64) for x in verts], np.asarray(o),
                        np.asarray(d), far, limit)
    blockers = []
    for j in ray.blockers:
        bary = np.array([ray.u[j], ray.v[j], 1.0 - ray.u[j] - ray.v[j]])
        blockers.append({"tri": int(j), "t": float(ray.t[j]), "edge_distance": float(bary.min()),
                         "edge_bound": _edge_bound(ray, j), "shared": _shared_edge(ray, j, bary)})
    return {"occluded": bool(blockers), "limit": ray.lim, "blockers": blockers}


def assert_occlusion_parity_at_scale(got, ref, a, b, c, o, d, origin_bound) -> dict:
    """Occlusion masks ``got`` and ``ref`` (bool (R,)) of shadow rays at the
    sizes people render, with the crack rule carried over to a boolean over a
    segment.  ``a``, ``b``, ``c``: the real triangles, (N, 3) each; ``o``,
    ``d``: the shadow rays as `occluded` takes them, (R, 3) float32, the same
    rays on both sides, or a pair ``(got's, ref's)`` where each side built
    its own; ``origin_bound`` as `occluded` takes it.  The rays are traced
    as `occluded` traces them: from ``o + d·far`` along ``−d``, occluded
    where a hit lies before ``far − eps`` (``eps``: ``SHADOW_EPS``).

    A ray is *divergent* where the flags differ.  Every divergent ray must
    meet all of:

    (a) float64 decides its flag: Möller–Trumbore over every triangle with
        the reference's acceptance, blockers strictly inside the segment;
    (b) the side that differs from float64 does so at a crack or at the
        segment's end.  Where float64 is occluded, every blocker lies within
        the crack rule's bound ``max(EDGE_EPS, UV_ATOL_AT_SCALE ×
        uv_condition)`` of an edge another real triangle shares, so float32
        can miss them all; where float64 is clear, some triangle lies within
        that bound outside such an edge inside the segment, so float32 can
        hit it.  In either case the triangle may instead lie, in float64 t,
        within ``SEGMENT_END_RTOL × grazing_factor × (far − eps)`` of the
        segment's end;
    (c) at least one side equals float64's flag (on its own ray), unless
        the segment's end explains both flips: where each side built its
        own ray, the two segments end ulps apart and both may straddle a
        blocker there.

    Divergent rays are checked one by one, each with its own float64 pass,
    so the first that breaks the rule raises at once.

    Returns ``rays``, ``occluded`` (per side), ``divergent`` (the rays'
    indices), ``agrees`` (per divergent ray: the side float64 sides with,
    ``"both"`` where each side equals float64 on its own ray, ``"neither"``
    where the segment's end explains both flips),
    ``edge_distance`` (per divergent ray: the largest barycentric distance
    its flip needed, ``None`` where the segment's end explains it) and
    ``near_threshold`` (the divergent rays the segment's end explains)."""
    got, ref = np.asarray(got, bool), np.asarray(ref, bool)
    if isinstance(o, (tuple, list)):
        rays = {"got": (np.asarray(o[0]), np.asarray(d[0])),
                "ref": (np.asarray(o[1]), np.asarray(d[1]))}
    else:
        rays = dict.fromkeys(("got", "ref"), (np.asarray(o), np.asarray(d)))
    verts = [np.asarray(x) for x in (a, b, c)]
    verts64 = [x.astype(np.float64) for x in verts]
    far, limit = _occlusion_limits(a, b, c, origin_bound)
    flags = {"got": got, "ref": ref}
    rows = np.flatnonzero(got != ref)
    agrees, edge_distance, near_threshold = [], [], []
    for r in rows:
        right, why, traced = [], {}, {}
        for side, (so, sd) in rays.items():
            # both sides on the same rays: one float64 pass serves both
            key = (id(so), id(sd))
            if key not in traced:
                traced[key] = _shadow_ray64(verts, verts64, so[r], sd[r], far, limit)
            ray = traced[key]
            if bool(flags[side][r]) == bool(len(ray.blockers)):
                right.append(side)
            else:
                why[side] = _explain_flip(ray, int(r), side)
        kinds = {k for k, _ in why.values()}
        assert right or kinds == {"near_threshold"}, (
            f"shadow ray {r}: neither side agrees with float64 on its own ray "
            f"(got {bool(got[r])}, ref {bool(ref[r])})")
        agrees.append(right[0] if len(right) == 1 else ("both" if right else "neither"))
        if kinds == {"near_threshold"}:
            near_threshold.append(int(r))
            edge_distance.append(None)
        else:
            edge_distance.append(max((x for k, x in why.values() if k == "edge_distance"),
                                     default=0.0))
    return {"rays": int(got.size), "occluded": {"got": int(got.sum()), "ref": int(ref.sum())},
            "divergent": [int(r) for r in rows], "agrees": agrees,
            "edge_distance": edge_distance, "near_threshold": near_threshold}


def assert_frame_parity_at_scale(got_u8, want_u8, explained) -> dict:
    """`compare_images` at the sizes people render, with every pixel more
    than 1/255 off accounted for.  ``got_u8``, ``want_u8``: (H, W, C) uint8
    frames in ray order (row 0 at the bottom, as ``render_frame`` returns
    them); ``explained``: the rays the crack rule
    (`assert_hit_parity_at_scale`) or the occlusion rule
    (`assert_occlusion_parity_at_scale`) lets differ: the crack rule's
    ``divergent`` and ``tie_rays`` (an exact-t tie shades the other
    triangle), the occlusion rule's ``divergent``.  The golden
    bound (more than 2/255 off on under 0.2 % of values) holds as well: at
    two million pixels it alone would hide four thousand wrong ones.

    Returns ``pixels``, ``beyond_1`` (the rays more than 1/255 off, all in
    ``explained``), ``beyond_2`` (how many of them are more than 2/255 off),
    ``max_diff`` and ``fraction_beyond_2`` (of channel values, as
    `compare_images` counts)."""
    frac = compare_images(got_u8, want_u8, "frame")
    got_u8, want_u8 = np.asarray(got_u8), np.asarray(want_u8)
    diff = np.abs(got_u8.astype(np.int32) - want_u8.astype(np.int32))
    diff = diff.reshape(-1, diff.shape[-1]).max(axis=1)
    off = np.flatnonzero(diff > 1)
    stray = np.setdiff1d(off, np.asarray(list(explained), np.int64))
    assert stray.size == 0, (
        f"{stray.size} pixels more than 1/255 off on rays neither rule lets differ "
        f"(first: {stray[:10].tolist()}, max diff {int(diff[stray].max())}/255)")
    return {"pixels": int(diff.size), "beyond_1": off.tolist(),
            "beyond_2": int((diff > 2).sum()), "max_diff": int(diff.max(initial=0)),
            "fraction_beyond_2": frac}


def encode_hits(mask, tri, shadow=None) -> dict:
    """The arrays of a stored answer (`load_hit_fixture` reads them back):
    ``rays``, ``mask_bits`` (`np.packbits` of the hit mask) and
    ``hit_tri_delta`` (the hit rays' triangle ids in ray order, delta-coded
    as int32); with ``shadow`` (an occlusion mask over the same rays) also
    ``shadow_bits``, its `np.packbits`."""
    mask = np.asarray(mask, bool)
    out = {"rays": np.int64(mask.size), "mask_bits": np.packbits(mask),
           "hit_tri_delta": np.diff(np.asarray(tri)[mask].astype(np.int64),
                                    prepend=0).astype(np.int32)}
    if shadow is not None:
        shadow = np.asarray(shadow, bool)
        assert shadow.shape == mask.shape, (shadow.shape, mask.shape)
        out["shadow_bits"] = np.packbits(shadow)
    return out


def load_hit_fixture(path, prefix: str = ""):
    """(hit mask, tri, occlusion mask) of a stored answer: ``mask_bits``
    (`np.packbits` of the mask over ``rays`` rays), ``hit_tri_delta`` (the
    hit rays' triangle ids in ray order, delta-coded, int32) and, where the
    file stores it, ``shadow_bits`` (None where it does not).  ``tri`` is 0
    on a miss, as a HitRecord has it.  A file that stores several answers
    names each one's arrays ``<prefix><key>``."""
    with np.load(path) as z:
        n = int(z[prefix + "rays"])
        mask = np.unpackbits(z[prefix + "mask_bits"], count=n).astype(bool)
        tri = np.zeros(n, np.int32)
        tri[mask] = np.cumsum(z[prefix + "hit_tri_delta"], dtype=np.int64).astype(np.int32)
        shadow = (np.unpackbits(z[prefix + "shadow_bits"], count=n).astype(bool)
                  if prefix + "shadow_bits" in z else None)
    return mask, tri, shadow


def config4_positions(a, b, c, phase: float) -> np.ndarray:
    """``bench.py``'s config-4 deformation, ``y += 0.5·sin(0.37·x + phase)``
    on every corner of the (T, 3) corner arrays ``a``, ``b``, ``c``, in
    numpy float32, as the (T, 3, 3) positions ``deform_scene`` takes.  Made
    once and handed to every package.  float32 ``np.sin`` may round
    otherwise on another numpy or CPU, so a stored answer keeps the
    positions' `bits_digest` beside it."""
    pos = np.stack([np.asarray(x, np.float32) for x in (a, b, c)], axis=1)
    pos[..., 1] += np.float32(0.5) * np.sin(pos[..., 0] * np.float32(0.37) + np.float32(phase))
    return pos


def bits_digest(*arrays) -> str:
    """SHA-256 (hex) of the arrays' bytes, one after another in C order."""
    h = hashlib.sha256()
    for x in arrays:
        h.update(np.ascontiguousarray(np.asarray(x)).tobytes())
    return h.hexdigest()


# A partitioned scene's arrays, in the order `partition_digest` hashes them.
SHARDED_FIELDS = ("tri_a", "tri_b", "tri_c", "a_uv", "b_uv", "c_uv", "a_normal", "b_normal",
                  "c_normal", "aabb_min", "aabb_max", "morton", "global_tri", "counts",
                  "range_min", "range_max")


def partition_digest(sscene) -> str:
    """`bits_digest` of a partitioned scene (either package's
    ``ShardedScene``, its arrays on the host) over ``SHARDED_FIELDS``, every
    integer array as int64: the port keeps Morton codes as int64 where the
    JAX package has uint32, with the same values."""
    def canonical(x):
        x = np.asarray(x)
        return x.astype(np.int64) if x.dtype.kind in "iu" else x

    return bits_digest(*(canonical(getattr(sscene, f)) for f in SHARDED_FIELDS))


def frame_subset(width: int, height: int, step: int) -> np.ndarray:
    """Row-major indices of every ``step``-th pixel of every ``step``-th row
    of a ``width`` x ``height`` frame, starting at pixel 0 (row 0 is the
    bottom, as `generate_rays` orders the rays)."""
    rows = np.arange(0, height, step, dtype=np.int64)
    cols = np.arange(0, width, step, dtype=np.int64)
    return (rows[:, None] * width + cols[None, :]).reshape(-1)


def hits_from_ids(mask, tri, a, b, c, o, d):
    """A hit record for a reference that stores only its mask and ids: t, u,
    v of each hit ray's triangle in float64 (`f64_on_triangle`), rounded to
    float32; t is ``MAX_FLOAT`` on a miss."""
    mask, tri = np.asarray(mask, bool), np.asarray(tri, np.int32)
    t, u, v = (x.astype(np.float32) for x in f64_on_triangle(a, b, c, o, d, tri))
    zero = np.float32(0.0)
    return SimpleNamespace(t=np.where(mask, t, MAX_FLOAT), tri=tri,
                           u=np.where(mask, u, zero), v=np.where(mask, v, zero))


def assert_bits_equal(got, want, name: str = "array"):
    """Same shape, same dtype kind and size, same bit pattern."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, f"{name}: shape {got.shape} != {want.shape}"
    assert got.dtype == want.dtype, f"{name}: dtype {got.dtype} != {want.dtype}"
    if got.dtype.kind == "f":
        view = {4: np.uint32, 8: np.uint64}[got.dtype.itemsize]
        got, want = got.view(view), want.view(view)
    bad = int(np.count_nonzero(got != want))
    assert bad == 0, f"{name}: {bad} of {got.size} elements differ"


def frame_to_uint8(image) -> np.ndarray:
    """Top-down float image in [0,1] → uint8, rounding as the PNG writer does."""
    return np.clip(np.asarray(image) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def compare_images(got_u8, want_u8, name: str = "image", tol: int = 2,
                   max_frac: float = 0.002) -> float:
    """Golden comparison: fewer than ``max_frac`` of the channel values may
    differ by more than ``tol``/255.  Returns the offending fraction."""
    got_u8, want_u8 = np.asarray(got_u8), np.asarray(want_u8)
    assert got_u8.shape == want_u8.shape, f"{name}: {got_u8.shape} != {want_u8.shape}"
    diff = np.abs(got_u8.astype(np.int32) - want_u8.astype(np.int32))
    frac_off = float((diff > tol).mean())
    assert frac_off < max_frac, (
        f"{name}: {frac_off:.4%} of pixels differ by more than {tol}/255 "
        f"(max diff {diff.max()})"
    )
    return frac_off
