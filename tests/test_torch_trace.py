"""Traversal parity of the PyTorch port against the JAX package.

The port's plain BVH4 traversal is held against the JAX Pallas BVH4 kernel
(interpret mode) and against the JAX per-ray BVH2 traversal on the same numpy
rays, under the parity contract: identical hit masks; t within rtol=4e-6;
tri mismatches only at exact-t ties; u, v within atol=1e-5 where tri agrees.

One stated widening of the u/v bound: XLA:CPU fuses multiply-adds that eager
PyTorch keeps apart, and u, v are quotients by det = e1·(d×e2), so a ray that
grazes its triangle amplifies that last-ulp difference by 1/|det|.  Seen on
soup300 / ray seed 3: ray 1665, |det| = 0.031 at distance 6.5, differs by
1.6e-5 in u.  The bound is therefore 1e-5 · max(1, 0.1/|det|) per ray
(`grazing_factor`); every ray with |det| >= 0.1 is still held to 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import unitysimpleraytracing_tpu as rt
from unitysimpleraytracing_tpu.ops import intersect as jintersect
from unitysimpleraytracing_tpu.ops import trace as jtrace
from unitysimpleraytracing_tpu.ops import trace_pallas4 as jt4
from unitysimpleraytracing_tpu_torch.ops import intersect as pintersect
from unitysimpleraytracing_tpu_torch.ops import trace as ptrace
from unitysimpleraytracing_tpu_torch.ops import trace_bvh4 as pt4
from unitysimpleraytracing_tpu_torch.utils.parity import assert_hit_parity, grazing_factor

from _torch_common import both_built, n_, rays, t_

MAXF = np.float32(rt.constants.MAX_FLOAT)
NAN, INF = np.float32(np.nan), np.float32(np.inf)


def test_d3d_min_max_nan_rule():
    a = np.float32([1.0, NAN, 3.0, NAN, -INF, 0.0])
    b = np.float32([2.0, 5.0, NAN, NAN, INF, -0.0])
    for pf, jf in ((pintersect.d3d_min, jintersect.d3d_min),
                   (pintersect.d3d_max, jintersect.d3d_max)):
        got, want = n_(pf(t_(a), t_(b))), np.asarray(jf(a, b))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_array_equal(got[:3], want[:3])
        np.testing.assert_array_equal(got[4:], want[4:])
    assert float(pintersect.d3d_min(t_(a), t_(b))[1]) == 5.0
    assert float(pintersect.d3d_max(t_(a), t_(b))[2]) == 3.0


def _box_cases():
    bmin = np.float32([[-1, -1, -1]] * 6)
    bmax = np.float32([[1, 1, 1]] * 6)
    origin = np.float32([
        [-5, 0, 0],      # hits head on
        [-5, 3, 0],      # passes above
        [5, 0, 0],       # box behind the ray
        [0, 0, 0],       # origin inside
        [-5, 1, 0],      # axis-parallel ray IN a face plane: 0·inf = NaN
        [-5, -1, 1],     # along an edge: two NaN slabs
    ])
    direc = np.float32([[1, 0, 0]] * 6)
    return bmin, bmax, origin, direc


def test_ray_box_hand_made_and_random():
    bmin, bmax, o, d = _box_cases()
    with np.errstate(divide="ignore"):
        inv = np.float32(1.0) / d
    got = n_(pintersect.ray_box(t_(bmin), t_(bmax), t_(o), t_(inv)))
    want = np.asarray(jintersect.ray_box(bmin, bmax, o, inv))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:4], [True, False, False, True])
    # Random boxes/rays, including exact zero direction components.
    rng = np.random.default_rng(1)
    lo = rng.uniform(-5, 5, size=(4096, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.1, 3, size=(4096, 3)).astype(np.float32)
    oo, dd = rays(4096, seed=2)
    dd[::7, 0] = 0.0
    dd[::11, 2] = 0.0
    with np.errstate(divide="ignore"):
        inv = np.float32(1.0) / dd
    got = n_(pintersect.ray_box(t_(lo), t_(hi), t_(oo), t_(inv)))
    np.testing.assert_array_equal(got, np.asarray(jintersect.ray_box(lo, hi, oo, inv)))
    assert 0 < got.sum() < got.size


def test_ray_triangle_hand_made():
    v0 = np.float32([[0, 0, 0]] * 5)
    v1 = np.float32([[1, 0, 0]] * 5)
    v2 = np.float32([[0, 1, 0]] * 5)
    o = np.float32([
        [0.25, 0.25, 1],    # hit at t=1, u=v=0.25
        [0.25, 0.25, -1],   # NEGATIVE t = -1 is accepted (no t>0 test)
        [2, 2, 1],          # outside: u > 1
        [0.25, 0.25, 1],    # parallel to the plane: |det| < 1e-8
        [-0.1, 0.5, 1],     # u < 0
    ])
    d = np.float32([[0, 0, -1], [0, 0, -1], [0, 0, -1], [1, 0, 0], [0, 0, -1]])
    t, u, v = (n_(x) for x in pintersect.ray_triangle(t_(o), t_(d), t_(v0), t_(v1), t_(v2)))
    jt, ju, jv = (np.asarray(x) for x in jintersect.ray_triangle(o, d, v0, v1, v2))
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_array_equal(t, np.float32([1, -1, MAXF, MAXF, MAXF]))
    np.testing.assert_array_equal(u[:2], ju[:2])
    np.testing.assert_array_equal(v[:2], jv[:2])
    assert (u[0], v[0]) == (0.25, 0.25)


def test_ray_triangle_random_parity():
    """Reject masks identical; t, u, v within rtol=4e-6 plus an absolute
    1e-5 scaled by the grazing factor (XLA may fuse multiply-adds in the dots
    and crosses; the quotient by det amplifies that on grazing rays)."""
    rng = np.random.default_rng(3)
    n = 8192
    c = rng.uniform(-3, 3, size=(n, 1, 3)).astype(np.float32)
    tri = c + rng.uniform(-1.5, 1.5, size=(n, 3, 3)).astype(np.float32)
    o = rng.uniform(-6, 6, size=(n, 3)).astype(np.float32)
    d = tri.mean(axis=1) + rng.normal(scale=0.7, size=(n, 3)).astype(np.float32) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    got = [n_(x) for x in pintersect.ray_triangle(
        t_(o), t_(d), t_(tri[:, 0]), t_(tri[:, 1]), t_(tri[:, 2]))]
    want = [np.asarray(x) for x in jintersect.ray_triangle(
        o, d, tri[:, 0], tri[:, 1], tri[:, 2])]
    acc_g, acc_w = got[0] != MAXF, want[0] != MAXF
    np.testing.assert_array_equal(acc_g, acc_w)
    assert 0.1 * n < acc_g.sum() < 0.9 * n
    scale = grazing_factor(tri[:, 0], tri[:, 1], tri[:, 2], d, np.arange(n))
    for g, w in zip(got, want):
        bound = 4e-6 * np.abs(w) + 1e-5 * scale
        assert np.all(np.abs(g - w)[acc_g] <= bound[acc_g])


# scene name, number of rays, ray seed, ray bound — the cases of the JAX
# package's own BVH4 kernel tests.
_CASES = {
    "soup300": (2048, 3, 8.0),
    "terrain20": (2048, 9, 14.0),
    "cube": (1024, 2, 4.0),
}


@pytest.fixture(scope="module", params=sorted(_CASES))
def traced(request):
    """One scene traced by every engine of both packages on the same rays."""
    name = request.param
    n, seed, bound = _CASES[name]
    js, jb, ps, pb = both_built(name)
    o, d = rays(n, seed, bound)
    table = pt4.prepare_tables4(ps, pb)
    jref = jtrace.traverse(js, jb, jnp.asarray(o), jnp.asarray(d))
    tri = ps.triangles
    return {
        "name": name,
        "uv_scale": grazing_factor(n_(tri.a), n_(tri.b), n_(tri.c), d, np.asarray(jref.tri)),
        "plain4": pt4.traverse_bvh4_plain(table, t_(o), t_(d)),
        "port_perray": ptrace.traverse(ps, pb, t_(o), t_(d)),
        "jax_pallas4": jt4.traverse_packets_pallas4(
            js, jb, jnp.asarray(o), jnp.asarray(d), interpret=True),
        "jax_perray": jref,
    }


def test_plain4_vs_jax_pallas4_kernel(traced):
    st = assert_hit_parity(
        traced["plain4"], traced["jax_pallas4"], uv_atol=1e-5, uv_scale=traced["uv_scale"])
    assert st["hits"] > 0


def test_plain4_vs_jax_perray(traced):
    assert_hit_parity(
        traced["plain4"], traced["jax_perray"], uv_atol=1e-5, uv_scale=traced["uv_scale"])


def test_port_perray_vs_jax_perray(traced):
    assert_hit_parity(
        traced["port_perray"], traced["jax_perray"], uv_atol=1e-5,
        uv_scale=traced["uv_scale"])


def test_plain4_vs_port_perray(traced):
    """Same float32 operations in both port engines: t, u, v bit-identical
    wherever the winning triangle agrees."""
    assert_hit_parity(traced["plain4"], traced["port_perray"], exact=True)


def test_misses_report_tri_zero(traced):
    h = traced["plain4"]
    miss = ~n_(h.hit)
    assert miss.any()
    assert np.all(n_(h.tri)[miss] == 0)
    assert np.all(n_(h.u)[miss] == 0) and np.all(n_(h.v)[miss] == 0)
    assert np.all(n_(h.t)[miss] == MAXF)
