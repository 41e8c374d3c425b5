"""The parity contract as assertion helpers (numpy only).

Used by the port's tests (JAX package vs port) and by ``chip_smoke.py``
(kernel vs plain version, frames vs goldens).  Every helper takes anything
``np.asarray`` accepts.

The contract (README "Parity contract"): identical hit masks; hit triangle
ids identical except at exact-t ties; t bounded relatively; build arrays bit
for bit; frames within ±2/255 on all but 0.2 % of pixels.
"""
from __future__ import annotations

import numpy as np

MAX_FLOAT = np.float32(3.4028234663852886e38)
# Relative bound on t between two traversal substrates, and the definition of
# an "exact-t tie" for triangle-id flips on shared edges.
_TIE_RTOL = 4e-6


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
