"""The crack rule (``utils/parity.assert_hit_parity_at_scale``) and the port
held to the JAX package at the main path's real sizes.

float32 Möller–Trumbore (Raytracing.compute:37-73) is not watertight: two
substrates that round differently let different rays through the crack along
an edge two triangles share.  At the test scenes' sizes no ray falls there;
at the bench's sizes some do.  The rule lets such a ray differ, and only such
a ray: float64 must hit it, within ``EDGE_EPS`` of an edge another triangle
shares, and one side must agree with float64.

- The rule itself, on hand-made two-triangle scenes (milliseconds).
- Config 2 (``bench.py:118-124``: 65,522 triangles, 512x512, the default
  tree) on the CPU: both trees bit-identical, JAX's ``render_hits`` against
  the port's ``plain4`` and ``plain2``, exactly one divergent ray, and JAX's
  answer equal to the committed fixture ``golden/torch_config2_hits_jax.npz``
  (which ``chip_smoke.py`` holds the card's kernels to).
- Config 3 (``bench.py:428-434``: 260,642 triangles, 1920x1056 primary rays)
  as a ``slow`` test: ``-m slow`` runs it.

``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_parity_scale.py`` writes the
fixture anew from the JAX package.
"""
import functools
import os
from types import SimpleNamespace

import numpy as np
import pytest

import unitysimpleraytracing_tpu as rt
import unitysimpleraytracing_tpu_torch as pt
from unitysimpleraytracing_tpu.ops import trace_pallas4 as jt4
from unitysimpleraytracing_tpu_torch.core.camera import generate_rays
from unitysimpleraytracing_tpu_torch.ops import trace_bvh4 as pt4
from unitysimpleraytracing_tpu_torch.utils import parity
from unitysimpleraytracing_tpu_torch.utils.parity import (
    EDGE_EPS, MAX_FLOAT, assert_hit_parity_at_scale, encode_hits, f64_nearest,
    hits_from_ids, load_hit_fixture,
)

from _torch_common import CPU, assert_same_bits, n_

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                       "torch_config2_hits_jax.npz")

# bench.py's configurations: (terrain_mesh kwargs, make_camera kwargs).
CONFIG2 = ({"res": 182, "size": 80.0, "amplitude": 9.0, "seed": 0},
           {"eye": (55.0, 45.0, 70.0), "target": (0.0, 0.0, 0.0), "width": 512,
            "height": 512, "fov_deg": 60.0})
CONFIG3 = ({"res": 362, "size": 160.0, "amplitude": 20.0, "seed": 1},
           {"eye": (110.0, 90.0, 140.0), "target": (0.0, 0.0, 0.0), "width": 1920,
            "height": 1056, "fov_deg": 60.0})
# chip_smoke.py's one-tree path at 1,048,352 triangles (main_path_1m).
CONFIG_1M = ({"res": 725, "size": 300.0, "amplitude": 30.0, "seed": 0},
             {"eye": (210.0, 170.0, 260.0), "target": (0.0, 0.0, 0.0), "width": 512,
              "height": 512, "fov_deg": 60.0})
_BVH_FIELDS = ("left", "right", "left_is_leaf", "right_is_leaf", "internal_parent",
               "leaf_parent", "range_first", "range_last", "split_axis", "node_aabb_min",
               "node_aabb_max", "sorted_tri", "depth")


# ---- the rule on two triangles --------------------------------------------

# A unit quad in z = 0 as two triangles sharing the diagonal (0,0,0)–(1,1,0):
# triangle 0 holds y <= x, triangle 1 holds y >= x; triangle 2 is triangle 0
# moved to z = -1, behind it.  Rays come down from z = 1.
_QUAD = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
_BELOW = np.float32([0, 0, -1])
_A, _B, _C = (np.stack([_QUAD[i], _QUAD[j], _QUAD[k] + _BELOW])
              for i, j, k in ((0, 0, 0), (1, 2, 1), (2, 3, 2)))


def _down(*xy):
    o = np.array([[x, y, 1.0] for x, y in xy], np.float32)
    return o, np.tile(np.float32([0, 0, -1]), (len(xy), 1))


def _record(tri):
    """Hits at t = 1 on the given triangle ids (None: a miss)."""
    hit = np.array([k is not None for k in tri])
    return SimpleNamespace(
        t=np.where(hit, np.float32(1.0), MAX_FLOAT).astype(np.float32),
        tri=np.array([k or 0 for k in tri], np.int32),
        u=np.full(len(tri), 0.25, np.float32), v=np.full(len(tri), 0.25, np.float32))


def test_rule_accepts_a_crack_on_the_shared_diagonal():
    # Ray 0 passes 2e-6 beside the diagonal on triangle 1's side; the others
    # hit the middle of a triangle and agree.
    o, d = _down((0.4, 0.400002), (0.7, 0.2), (0.2, 0.7))
    st = assert_hit_parity_at_scale(_record([None, 0, 1]), _record([1, 0, 1]), _A, _B, _C, o, d)
    assert st["divergent"] == [0] and st["agrees"] == ["ref"] and st["f64_tri"] == [1]
    assert st["across_edge"] == [] and 0 < st["max_edge_distance"] <= EDGE_EPS
    assert st["rays"] == 2 and st["hits"] == 2
    st = assert_hit_parity_at_scale(_record([1, 0, 1]), _record([None, 0, 1]), _A, _B, _C, o, d)
    assert st["agrees"] == ["got"]


def test_rule_refuses_a_ray_far_from_every_edge():
    o, d = _down((0.6, 0.3))  # barycentrics (0.3, 0.3, 0.4) on triangle 0
    with pytest.raises(AssertionError, match="beyond max"):
        assert_hit_parity_at_scale(_record([None]), _record([0]), _A, _B, _C, o, d)


def test_rule_widens_the_edge_bound_by_the_conditioning_of_u_and_v():
    # Seen from z = 1000, u and v carry about 1.7e-4 of float32 error
    # (eps x uv_condition = 1.19e-7 x 1414), and the edge bound is 4 eps x
    # 1414 = 6.7e-4: a ray 3e-4 beside the diagonal, beyond EDGE_EPS, can
    # fall through the crack.  The same ray seen from z = 1 cannot, nor can
    # a ray 2e-3 beside the diagonal from z = 1000.
    o, d = _down((0.4, 0.4003))
    o[:, 2] = 1000.0
    st = assert_hit_parity_at_scale(_record([None]), _record([1]), _A, _B, _C, o, d)
    assert st["agrees"] == ["ref"] and EDGE_EPS < st["max_edge_distance"] < st["edge_bound"][0]
    np.testing.assert_allclose(st["edge_bound"][0], 4 * np.finfo(np.float32).eps * 1000 * 2**0.5,
                               rtol=1e-3)
    for xy, z in (((0.4, 0.4003), 1.0), ((0.4, 0.402), 1000.0)):
        o, d = _down(xy)
        o[:, 2] = z
        with pytest.raises(AssertionError, match="beyond max"):
            assert_hit_parity_at_scale(_record([None]), _record([1]), _A, _B, _C, o, d)


def test_rule_refuses_a_crack_on_a_boundary_edge():
    o, d = _down((0.5, 0.000002))  # beside the edge y = 0, triangle 0's alone
    with pytest.raises(AssertionError, match="no other triangle shares"):
        assert_hit_parity_at_scale(_record([None]), _record([0]), _A, _B, _C, o, d)


def test_rule_accepts_the_neighbour_across_the_edge_at_a_tie():
    # float64 hits triangle 1 2e-6 beside the diagonal; a side that hit
    # triangle 0, across the diagonal at the same t, agrees up to that tie.
    o, d = _down((0.4, 0.400002))
    st = assert_hit_parity_at_scale(_record([None]), _record([0]), _A, _B, _C, o, d)
    assert st["agrees"] == ["ref"] and st["across_edge"] == [0] and st["f64_tri"] == [1]


def test_rule_refuses_when_neither_side_agrees_with_float64():
    o, d = _down((0.4, 0.400002))  # float64: triangle 1; triangle 2 lies behind
    with pytest.raises(AssertionError, match="neither side agrees"):
        assert_hit_parity_at_scale(_record([None]), _record([2]), _A, _B, _C, o, d)


def test_rule_refuses_a_ray_float64_misses_and_holds_the_other_rays():
    o, d = _down((1.5, 0.5), (0.7, 0.2))
    with pytest.raises(AssertionError, match="float64 misses"):
        assert_hit_parity_at_scale(_record([None, 0]), _record([0, 0]), _A, _B, _C, o, d)
    # Rays that do not diverge still answer to assert_hit_parity: a t off by
    # more than the tie bound on the same triangle is not a crack.
    got, ref = _record([0, 0]), _record([0, 0])
    got.t[1] = np.float32(1.001)
    with pytest.raises(AssertionError):
        assert_hit_parity_at_scale(got, ref, _A, _B, _C, o, d)


def test_rule_scales_the_t_bound_of_a_grazing_ray():
    # A ray 0.01 rad above the quad's plane (grazing factor 10): on one
    # triangle, t may differ by up to 4e-5 relative, not more.
    d = np.float32([[1.0, 0.0, -0.01]])
    d /= np.linalg.norm(d)
    o = np.float32([[0.5, 0.2, 0.0]]) - d
    got, ref = _record([0]), _record([0])
    got.t[0] = np.float32(1.00002)
    st = assert_hit_parity_at_scale(got, ref, _A, _B, _C, o, d)
    assert st["grazing_t"] == [0] and st["divergent"] == [] and st["rays"] == 0
    got.t[0] = np.float32(1.0001)
    with pytest.raises(AssertionError, match="grazing factor"):
        assert_hit_parity_at_scale(got, ref, _A, _B, _C, o, d)


def test_f64_nearest_ties_go_to_the_lower_id_and_name_the_edge():
    o, d = _down((0.5, 0.5), (0.7, 0.2), (1.5, 0.5))
    f = f64_nearest(_A, _B, _C, o, d, [0, 1, 2])
    assert f["tri"].tolist() == [0, 0, -1]
    assert f["t"][0] == 1.0 and np.isinf(f["t"][2])
    assert f["edge_distance"][0] == 0.0
    # Ray 0 lies on the diagonal: triangle 0's vertices a and c.
    np.testing.assert_array_equal(f["edge"][0], _QUAD[[0, 2]])
    np.testing.assert_allclose(f["edge_distance"][1], 0.2)


def test_fixture_codec_round_trips(tmp_path):
    rng = np.random.default_rng(0)
    mask = rng.random(1001) < 0.3
    tri = np.where(mask, rng.integers(0, 70000, 1001), 0).astype(np.int32)
    path = tmp_path / "hits.npz"
    np.savez_compressed(path, **encode_hits(mask, tri))
    got_mask, got_tri, got_shadow = load_hit_fixture(path)
    np.testing.assert_array_equal(got_mask, mask)
    np.testing.assert_array_equal(got_tri, tri)
    assert got_shadow is None


def test_hits_from_ids_is_float64_of_the_stored_triangle():
    o, d = _down((0.7, 0.2), (1.5, 0.5))
    h = hits_from_ids([True, False], [0, 0], _A, _B, _C, o, d)
    assert h.t.dtype == np.float32 and h.t[0] == 1.0 and h.t[1] == MAX_FLOAT
    np.testing.assert_allclose([h.u[0], h.v[0]], [0.5, 0.2], rtol=1e-6)


# ---- the JAX package's answer and the fixture -------------------------------

def _jax_side(cfg):
    mesh_kw, cam_kw = cfg
    scene = rt.build_scene(rt.terrain_mesh(**mesh_kw))
    bvh = rt.build_bvh(scene)
    cam = rt.make_camera(**cam_kw)
    return scene, bvh, cam, rt.render_hits(scene, bvh, cam)


def _port_side(cfg):
    mesh_kw, cam_kw = cfg
    scene = pt.build_scene(pt.terrain_mesh(**mesh_kw), device=CPU)
    bvh = pt.build_bvh(scene)
    cam = pt.make_camera(**cam_kw, device=CPU)
    return scene, bvh, cam


def write_fixture(path: str = FIXTURE) -> None:
    """Write JAX's config-2 answer (`render_hits`, default tree) as the fixture."""
    *_, hits = _jax_side(CONFIG2)
    np.savez_compressed(path, **encode_hits(n_(hits.t) != MAX_FLOAT, n_(hits.tri)))


def _hits_np(h):
    return SimpleNamespace(**{f: n_(getattr(h, f)) for f in ("t", "tri", "u", "v")})


@functools.lru_cache(maxsize=None)
def _both(cfg_name):
    """One JAX build and trace, one port build, per configuration."""
    cfg = {"config2": CONFIG2, "config3": CONFIG3}[cfg_name]
    js, jb, _, jh = _jax_side(cfg)
    ps, pb, pc = _port_side(cfg)
    o, d = (n_(x) for x in generate_rays(pc))
    tris = ps.triangles
    a, b, c = (n_(x)[:ps.count] for x in (tris.a, tris.b, tris.c))
    return SimpleNamespace(js=js, jb=jb, jh=_hits_np(jh), ps=ps, pb=pb, pc=pc,
                           o=o, d=d, a=a, b=b, c=c)


@functools.lru_cache(maxsize=None)
def _port_hits(cfg_name, impl):
    s = _both(cfg_name)
    return _hits_np(pt.render_hits(s.ps, s.pb, s.pc, impl=impl))


def _at_scale(s, got, ref=None):
    return assert_hit_parity_at_scale(got, s.jh if ref is None else ref,
                                      s.a, s.b, s.c, s.o, s.d)


def test_config2_trees_and_tables_bit_identical():
    s = _both("config2")
    assert s.ps.count == 65522
    assert_same_bits(s.ps.morton, s.js.morton, "morton")
    for f in _BVH_FIELDS:
        assert_same_bits(getattr(s.pb, f), getattr(s.jb, f), f)
    assert_same_bits(pt4.prepare_tables4(s.ps, s.pb), jt4.prepare_tables4(s.js, s.jb, pack=1),
                     "BVH4 table")


@pytest.mark.parametrize("impl", ["plain4", "plain2"])
def test_config2_one_crack_ray_where_the_port_sides_with_float64(impl):
    s = _both("config2")
    got = _port_hits("config2", impl)
    st = _at_scale(s, got)
    assert st["divergent"] == [108203], st["divergent"]
    assert st["agrees"] == ["got"] and st["f64_tri"] == [20437]
    assert got.t[108203] != MAX_FLOAT and got.tri[108203] == 20437
    assert s.jh.t[108203] == MAX_FLOAT
    assert 4e-6 < st["max_edge_distance"] < 5e-6 and st["across_edge"] == []
    # Two grazing rays (grazing factor 49 and 203) whose t differ by 8.4e-6
    # and 8.0e-6 relative on the same triangle; 135,822's rays are
    # bit-identical in both packages.
    assert st["grazing_t"] == [135822, 155082], st["grazing_t"]
    assert st["tri_ties"] == 0 and st["hits"] + 2 == 80947
    assert st["rays"] == 512 * 512 - 1 - 2


def test_config2_jax_answer_equals_the_fixture():
    s = _both("config2")
    want = encode_hits(s.jh.t != MAX_FLOAT, s.jh.tri)
    with np.load(FIXTURE) as z:
        assert sorted(z.files) == sorted(want)
        for k, v in want.items():
            parity.assert_bits_equal(z[k], v, k)
    mask, tri, _ = load_hit_fixture(FIXTURE)
    np.testing.assert_array_equal(mask, s.jh.t != MAX_FLOAT)
    np.testing.assert_array_equal(tri[mask], s.jh.tri[mask])


def test_config2_fixture_as_the_card_reads_it():
    """What ``chip_smoke.py``'s ``parity_scale`` does with the fixture, here
    with the plain version: float64 t, u, v of JAX's triangles stand in for
    the t, u, v the fixture does not store."""
    s = _both("config2")
    mask, tri, _ = load_hit_fixture(FIXTURE)
    ref = hits_from_ids(mask, tri, s.a, s.b, s.c, s.o, s.d)
    st = _at_scale(s, _port_hits("config2", "plain4"), ref)
    assert st["divergent"] == [108203] and st["agrees"] == ["got"]


@pytest.mark.slow
def test_config3_cracks_and_ties():
    s = _both("config3")
    assert s.ps.count == 260642
    got = _port_hits("config3", "plain4")
    st = _at_scale(s, got)
    rows = np.asarray(st["divergent"])
    hit_g, hit_j = got.t != MAX_FLOAT, s.jh.t != MAX_FLOAT
    masks = rows[hit_g[rows] != hit_j[rows]].tolist()
    assert masks == [463816, 582869, 682497, 809183, 855667, 956884, 1014266], st
    assert sorted(set(rows.tolist()) - set(masks)) == [
        1060878, 1122217, 1124269, 1148854, 1301057], st
    assert st["tri_ties"] == 31, st
    # float64 sides with the port on 9 of the 12; 3 of the 12 agree through
    # a tie with the triangle across the shared edge.
    assert st["agrees"].count("got") == 9, st
    assert st["across_edge"] == [463816, 809183, 956884], st
    assert len(st["grazing_t"]) == 20, st["grazing_t"]


if __name__ == "__main__":
    write_fixture()
    print(f"wrote {FIXTURE} ({os.path.getsize(FIXTURE)} bytes)")
