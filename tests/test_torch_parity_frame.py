"""The occlusion rule and the frame rule (``utils/parity``), and the shadowed
frame and the animated frame held to the JAX package at the bench's sizes.

A shadow ray is a boolean over a segment, not a nearest hit, so the crack
rule of ``test_torch_parity_scale.py`` does not cover it:
``assert_occlusion_parity_at_scale`` lets two occlusion flags differ only
where float64 puts the ray in a crack along an edge two triangles share, or
a blocker at the segment's end.  ``assert_frame_parity_at_scale`` lets a
pixel be more than 1/255 off only on a ray one of the two rules lists.

- The occlusion rule on hand-made scenes (milliseconds).
- Config 2 (``bench.py:118-124``: 65,522 triangles, 512x512, the default
  tree; chip_smoke.py's texture and background) on the CPU: both packages'
  ``occluded`` on the same shadow rays, each package's own ``render_frame``
  with shadows, and JAX's answer equal to ``golden/torch_config2_frame_jax.npz``.
- Config 4 (``bench.py:248-266``: the config-2 scene deformed by
  ``0.5·sin(0.37·x + phase)`` on y): refit and Karras rebuild bit-identical,
  the animated frame under the crack rule, JAX's answer equal to
  ``golden/torch_config4_jax.npz``.
- Config 3 (``bench.py:428-434``: 260,642 triangles, 1920x1056) as ``slow``
  tests: ``-m slow`` runs them; JAX's frame alone takes about two minutes.

``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_parity_frame.py
[config2 config3 config4]`` writes the fixtures anew from the JAX package;
``... tests/test_torch_parity_frame.py repeat N [port] [jax]`` renders config
3's frame N times per package and prints each frame's SHA-256.
"""
import functools
import os
import sys
from types import SimpleNamespace
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unitysimpleraytracing_tpu as rt
import unitysimpleraytracing_tpu_torch as pt
from unitysimpleraytracing_tpu.ops import dispatch as jdispatch
from unitysimpleraytracing_tpu.ops import trace_pallas4 as jt4
from unitysimpleraytracing_tpu.pipeline import render as jrender
from unitysimpleraytracing_tpu_torch.core.camera import generate_rays
from unitysimpleraytracing_tpu_torch.core.types import HitRecord
from unitysimpleraytracing_tpu_torch.ops import dispatch as pdispatch
from unitysimpleraytracing_tpu_torch.ops import trace_bvh4 as pt4
from unitysimpleraytracing_tpu_torch.pipeline import render as prender
from unitysimpleraytracing_tpu_torch.utils import parity
from unitysimpleraytracing_tpu_torch.utils.parity import (
    MAX_FLOAT, assert_frame_parity_at_scale, assert_hit_parity_at_scale,
    assert_occlusion_parity_at_scale, bits_digest, config4_positions, encode_hits,
    float64_occlusion, frame_to_uint8, load_hit_fixture,
)

from _torch_common import CPU, assert_same_bits, n_, t_
from test_torch_parity_scale import _BVH_FIELDS, CONFIG2, CONFIG3, CONFIG_1M

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
FIXTURES = {name: os.path.join(GOLDEN, f"torch_{name}_jax.npz")
            for name in ("config2_frame", "config3", "config4")}
# Config "1m" is held by test_torch_parity_large.py through the helpers below.
CONFIGS = {"config2": CONFIG2, "config3": CONFIG3, "1m": CONFIG_1M}
# chip_smoke.py's main-path texture and background.
TEX = (0.8, 0.7, 0.6, 1.0)
BG = np.asarray([0.1, 0.1, 0.12], np.float32)
# Config 4's phases: bench.py times the refit at 0.7 and the frame at 0.9.
REFIT_PHASE, FRAME_PHASE = 0.7, 0.9
# Shadow rays on which JAX's own flag differs from float64 of its own ray
# only through a blocker near an edge no other triangle shares (the
# terrain's boundary), while the port's equals float64 on its own ray.  The
# occlusion rule refuses a flip at a boundary edge, so such a ray is pinned
# here, with why, and not explained by the rule.
REFERENCE_FLIPS = {"config2": [], "config3": [542709]}


# ---- the occlusion rule on hand-made scenes ---------------------------------

# A unit quad in z = 0 as two triangles sharing the diagonal (0,0,0)–(1,1,0)
# (triangle 0 holds y <= x, triangle 1 y >= x); triangle 2 is triangle 0
# moved to z = -1.  Shadow rays go up +z from below the quad.
_QUAD = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
_A, _B, _C = (np.stack([_QUAD[i], _QUAD[j], _QUAD[k] + np.float32([0, 0, -1])])
              for i, j, k in ((0, 0, 0), (1, 2, 1), (2, 3, 2)))
# A roof: two triangles sharing the ridge (0,0,0)–(1,0,0), sloping down to
# z = -1 on either side.  A ray just above the ridge misses both.
_RA, _RB = np.float32([[0, 0, 0]] * 2), np.float32([[1, 0, 0]] * 2)
_RC = np.float32([[0.5, 1, -1], [0.5, -1, -1]])


def _up(*xyz):
    o = np.array(xyz, np.float32)
    return o, np.tile(np.float32([0, 0, 1]), (len(xyz), 1))


def test_occlusion_rule_accepts_a_crack_on_the_shared_diagonal():
    # Ray 0 passes 2e-6 inside triangle 1 beside the diagonal; ray 1 goes
    # through the middle of triangle 0, and both sides see it.
    o, d = _up((0.4, 0.400002, -0.5), (0.7, 0.2, -0.5))
    st = assert_occlusion_parity_at_scale([False, True], [True, True], _A, _B, _C, o, d, 1.0)
    assert st["divergent"] == [0] and st["agrees"] == ["ref"] and st["near_threshold"] == []
    assert 0 < st["edge_distance"][0] < parity.EDGE_EPS
    assert st["rays"] == 2 and st["occluded"] == {"got": 1, "ref": 2}
    st = assert_occlusion_parity_at_scale([True, True], [False, True], _A, _B, _C, o, d, 1.0)
    assert st["agrees"] == ["got"]


def test_occlusion_rule_accepts_a_crack_over_a_shared_ridge():
    # A ray 1e-6 above the ridge, across it: float64 sees no blocker, a
    # float32 side may hit either slope.
    o, d = np.float32([[0.5, -0.5, 1e-6]]), np.float32([[0, 1, 0]])
    st = assert_occlusion_parity_at_scale([True], [False], _RA, _RB, _RC, o, d, 5.0)
    assert st["divergent"] == [0] and st["agrees"] == ["ref"]
    assert 0 < st["edge_distance"][0] < parity.EDGE_EPS


def test_occlusion_rule_refuses_a_ray_far_from_every_edge():
    o, d = _up((0.6, 0.3, -0.5))  # barycentrics (0.3, 0.3, 0.4) on triangle 0
    with pytest.raises(AssertionError, match="not in a crack"):
        assert_occlusion_parity_at_scale([False], [True], _A, _B, _C, o, d, 1.0)
    o, d = np.float32([[0.5, -0.5, 0.01]]), np.float32([[0, 1, 0]])  # 0.01 over the ridge
    with pytest.raises(AssertionError, match="finds none"):
        assert_occlusion_parity_at_scale([True], [False], _RA, _RB, _RC, o, d, 5.0)


def test_occlusion_rule_refuses_a_crack_on_a_boundary_edge():
    o, d = _up((0.5, 0.000002, -0.5))  # beside the edge y = 0, triangle 0's alone
    with pytest.raises(AssertionError, match="not in a crack"):
        assert_occlusion_parity_at_scale([False], [True], _A, _B, _C, o, d, 1.0)


def test_occlusion_rule_accepts_a_blocker_at_the_segments_end():
    # The shadow ray starts eps = 4e-3 below the quad's middle: the quad lies
    # at the segment's end, far − eps from the far point, either side of it.
    o, d = _up((0.6, 0.3, -0.004))
    for got, ref in (([False], [True]), ([True], [False])):
        st = assert_occlusion_parity_at_scale(got, ref, _A, _B, _C, o, d, 1.0)
        assert st["near_threshold"] == [0] and st["edge_distance"] == [None]
    # 4e-4 further down it is no rounding: the quad lies inside the segment.
    o, d = _up((0.6, 0.3, -0.0044))
    with pytest.raises(AssertionError, match="not in a crack"):
        assert_occlusion_parity_at_scale([False], [True], _A, _B, _C, o, d, 1.0)


def test_occlusion_rule_refuses_when_neither_side_agrees_with_float64():
    # Each side on its own ray: got's passes 2e-6 inside the slope y > 0
    # (float64 occluded, got clear), ref's 1e-6 over the ridge (float64
    # clear, ref occluded).  Each flip alone is a crack; both at once is not.
    o = (np.float32([[0.5, 2e-6, -5]]), np.float32([[0.5, -0.5, 1e-6]]))
    d = (np.float32([[0, 0, 1]]), np.float32([[0, 1, 0]]))
    with pytest.raises(AssertionError, match="neither side agrees"):
        assert_occlusion_parity_at_scale([False], [True], _RA, _RB, _RC, o, d, 5.0)


def test_frame_rule_holds_every_pixel_beyond_one_level():
    want = np.full((32, 64, 4), 100, np.uint8)
    got = want.copy()
    got[1, 2, 0] = 140  # ray 1 * 64 + 2 = 66
    got[3, 7, 1] = 101  # one level: allowed anywhere
    st = assert_frame_parity_at_scale(got, want, [66])
    assert st["beyond_1"] == [66] and st["beyond_2"] == 1 and st["max_diff"] == 40
    with pytest.raises(AssertionError, match="neither rule lets differ"):
        assert_frame_parity_at_scale(got, want, [65])
    # Explained pixels still count against the golden bound.
    got[:4, :, 0] = 140
    with pytest.raises(AssertionError, match="more than 2/255"):
        assert_frame_parity_at_scale(got, want, range(32 * 64))


def test_fixture_codec_round_trips_an_occlusion_mask(tmp_path):
    rng = np.random.default_rng(0)
    mask, shadow = rng.random(1001) < 0.3, rng.random(1001) < 0.1
    tri = np.where(mask, rng.integers(0, 70000, 1001), 0).astype(np.int32)
    np.savez_compressed(tmp_path / "a.npz", **encode_hits(mask, tri, shadow))
    got = load_hit_fixture(tmp_path / "a.npz")
    for g, w in zip(got, (mask, tri, shadow)):
        np.testing.assert_array_equal(g, w)


# ---- the two packages at the bench's sizes ----------------------------------

def _hits_np(h):
    return SimpleNamespace(**{f: n_(getattr(h, f)) for f in ("t", "tri", "u", "v")})


def _jax_shadow(scene, bvh, hits, cam, impl):
    """JAX's own shadow mask (``_shadow_mask``, jitted) and the shadow rays
    and ``origin_bound`` it handed `occluded`, caught on their way in: JAX
    builds them under XLA, which may fuse ``o + t·d`` where the port rounds
    twice, so a copy built outside would not be JAX's own rays.  The rays
    come back in row-major order."""
    seen, real = {}, jdispatch.occluded

    def spy(scene, bvh, origins, dirs, **kw):
        seen.update(o=origins, d=dirs, origin_bound=kw["origin_bound"])
        return real(scene, bvh, origins, dirs, **kw)

    def own(scene, bvh, hits, cam):
        with mock.patch.object(jdispatch, "occluded", spy):
            mask = jrender._shadow_mask(scene, bvh, hits, impl, cam)
        return mask, seen["o"], seen["d"], seen["origin_bound"]

    mask, o, d, bound = jax.jit(own)(scene, bvh, hits, cam)
    h, w = cam.height, cam.width
    o, d = (n_(pdispatch._row_major(t_(n_(x)), h, w, 32)) for x in (o, d))
    return n_(mask), o, d, float(bound)


@functools.lru_cache(maxsize=None)
def _jax(cfg_name):
    """The JAX package's answers: default tree, `render_hits`, its own shadow
    mask and shadow rays (`_jax_shadow`), and `render_frame` with shadows,
    as uint8."""
    mesh_kw, cam_kw = CONFIGS[cfg_name]
    scene = rt.build_scene(rt.terrain_mesh(**mesh_kw))
    bvh = rt.build_bvh(scene)
    cam = rt.make_camera(**cam_kw)
    hits = rt.render_hits(scene, bvh, cam)
    impl = jdispatch.resolve_impl("auto", bvh.capacity)
    shadow, so, sd, bound = _jax_shadow(scene, bvh, hits, cam, impl)
    frame = rt.render_frame(scene, bvh, cam, rt.solid_texture(TEX), BG, shadows=True)
    return SimpleNamespace(scene=scene, bvh=bvh, cam=cam, impl=impl, hits=_hits_np(hits),
                           shadow=shadow, so=so, sd=sd, origin_bound=bound,
                           frame=frame_to_uint8(n_(frame)))


@functools.lru_cache(maxsize=None)
def _port(cfg_name):
    """The port's answers on the CPU (``plain4``), as `_jax`'s, plus the
    frame's primary rays, its own shadow rays and the real triangles."""
    mesh_kw, cam_kw = CONFIGS[cfg_name]
    scene = pt.build_scene(pt.terrain_mesh(**mesh_kw), device=CPU)
    bvh = pt.build_bvh(scene)
    cam = pt.make_camera(**cam_kw, device=CPU)
    hits = pt.render_hits(scene, bvh, cam)
    shadow = prender._shadow_mask(scene, bvh, hits, "plain4", cam)
    frame = pt.render_frame(scene, bvh, cam, pt.solid_texture(TEX, device=CPU), BG,
                            shadows=True)
    o, d = generate_rays(cam)
    so, sd, ob = (n_(x) for x in prender.shadow_rays(scene, bvh, hits, cam))
    tris = scene.triangles
    return SimpleNamespace(
        scene=scene, bvh=bvh, cam=cam, hits=_hits_np(hits), shadow=n_(shadow),
        frame=frame_to_uint8(n_(frame)), torch_hits=hits, o=o, d=d, on=n_(o), dn=n_(d),
        so=so, sd=sd, origin_bound=float(ob),
        a=n_(tris.a)[:scene.count], b=n_(tris.b)[:scene.count], c=n_(tris.c)[:scene.count])


def _as_port_hits(h):
    return HitRecord(t=t_(h.t), tri=t_(h.tri), u=t_(h.u), v=t_(h.v))


@functools.lru_cache(maxsize=None)
def _shared_shadow(cfg_name):
    """Both packages' `occluded` on the SAME shadow rays: built once, with the
    port's `_shadow_rays_from`, from JAX's primary hits; traced in the
    frame's 32x32 tile-major order, as `_shadow_mask` traces them."""
    j, p = _jax(cfg_name), _port(cfg_name)
    so, sd, ob = prender._shadow_rays_from(p.scene, p.bvh, _as_port_hits(j.hits), p.o, p.d)
    h, w = p.cam.height, p.cam.width

    def tiled(x):
        return pdispatch._tile_major(x, h, w, 32).contiguous()

    port = pdispatch._row_major(
        pdispatch.occluded(p.scene, p.bvh, tiled(so), tiled(sd), impl="plain4",
                           origin_bound=ob), h, w, 32)
    jo = jdispatch.occluded(j.scene, j.bvh, jnp.asarray(n_(tiled(so))),
                            jnp.asarray(n_(tiled(sd))), impl=j.impl,
                            origin_bound=jnp.float32(n_(ob)))
    jax_occ = pdispatch._row_major(t_(n_(jo)), h, w, 32)
    return SimpleNamespace(o=n_(so), d=n_(sd), origin_bound=float(ob), port=n_(port),
                           jax=n_(jax_occ))


def _shared_rule(cfg_name):
    p, s = _port(cfg_name), _shared_shadow(cfg_name)
    return assert_occlusion_parity_at_scale(s.port, s.jax, p.a, p.b, p.c, s.o, s.d,
                                            s.origin_bound)


def frame_rules(j, p, pinned=()) -> SimpleNamespace:
    """Each package's own frame under the frame rule (``j``, ``p``: the two
    packages' answers, as `_jax` and `_port` give them; ``p`` also carries
    the real triangles and the primary rays).  The rays the rules let
    differ: the primary rays the crack rule lists (divergent, and ids
    flipped at an exact-t tie), and, where both sides hit the same triangle,
    the shadow rays whose flags differ and meet the occlusion rule with each
    side on its own shadow ray.  ``pinned``: shadow rays where JAX's own
    flag differs from float64 of its own ray at an edge no triangle shares
    (asserted here, ray by ray)."""
    hit_st = assert_hit_parity_at_scale(p.hits, j.hits, p.a, p.b, p.c, p.on, p.dn)
    assert p.origin_bound == j.origin_bound
    hit = p.hits.t != MAX_FLOAT
    pinned = list(pinned)
    both = np.setdiff1d(
        np.flatnonzero(hit & (j.hits.t != MAX_FLOAT) & (p.hits.tri == j.hits.tri)), pinned)
    occ_st = assert_occlusion_parity_at_scale(
        p.shadow[both], j.shadow[both], p.a, p.b, p.c, (p.so[both], j.so[both]),
        (p.sd[both], j.sd[both]), j.origin_bound)
    for r in pinned:
        mine = float64_occlusion(p.a, p.b, p.c, p.so[r], p.sd[r], j.origin_bound)
        theirs = float64_occlusion(p.a, p.b, p.c, j.so[r], j.sd[r], j.origin_bound)
        assert p.shadow[r] == mine["occluded"] == theirs["occluded"] != j.shadow[r], r
        assert all(x["edge_distance"] <= x["edge_bound"] and not x["shared"]
                   for x in theirs["blockers"]), (r, theirs)
    shadow_rays = both[occ_st["divergent"]].tolist()
    frame_st = assert_frame_parity_at_scale(
        p.frame, j.frame, hit_st["divergent"] + hit_st["tie_rays"] + shadow_rays + pinned)
    return SimpleNamespace(hits=hit_st, occ=occ_st, shadow_rays=shadow_rays, frame=frame_st)


@functools.lru_cache(maxsize=None)
def _frame_rules(cfg_name):
    return frame_rules(_jax(cfg_name), _port(cfg_name), REFERENCE_FLIPS[cfg_name])


def _fixture_equals_jax(name, want):
    with np.load(FIXTURES[name]) as z:
        assert sorted(z.files) == sorted(want), (sorted(z.files), sorted(want))
        for k, v in want.items():
            parity.assert_bits_equal(z[k], v, k)


def _frame_fixture(cfg_name):
    j = _jax(cfg_name)
    return {**encode_hits(j.hits.t != MAX_FLOAT, j.hits.tri, j.shadow), "frame_u8": j.frame}


def test_config2_shadow_masks_on_shared_rays():
    st = _shared_rule("config2")
    assert st["rays"] == 512 * 512
    assert st["divergent"] == [], st
    assert st["occluded"]["got"] == st["occluded"]["ref"] > 0, st


def test_config2_frames_under_the_frame_rule():
    st = _frame_rules("config2")
    assert st.hits["divergent"] == [108203], st.hits["divergent"]
    assert st.occ["divergent"] == [], st.occ
    assert st.frame["beyond_1"] == [108203], st.frame
    assert st.frame["beyond_2"] == 1, st.frame


def test_config2_frame_fixture_equals_jax():
    _fixture_equals_jax("config2_frame", _frame_fixture("config2"))


# ---- config 4: the deforming mesh -------------------------------------------

def _corners(scene):
    t = scene.triangles
    return n_(t.a), n_(t.b), n_(t.c)


@functools.lru_cache(maxsize=None)
def _config4():
    """Both packages on the config-2 scene and default tree, deformed by the
    same numpy positions: the refit at REFIT_PHASE, the Karras rebuild of
    that deformed scene, the animated frame at FRAME_PHASE."""
    j, p = _jax("config2"), _port("config2")
    pos = {ph: config4_positions(*_corners(p.scene), ph) for ph in (REFIT_PHASE, FRAME_PHASE)}
    js2 = rt.deform_scene(j.scene, jnp.asarray(pos[REFIT_PHASE]))
    ps2 = pt.deform_scene(p.scene, t_(pos[REFIT_PHASE]))
    out = SimpleNamespace(
        pos=pos, j_refit=rt.refit_bvh(js2, j.bvh), p_refit=pt.refit_bvh(ps2, p.bvh),
        j_karras=rt.build_bvh(js2, builder="karras"), p_karras=pt.build_bvh(ps2, builder="karras"),
        j_frame=_hits_np(rt.make_animated_renderer(j.scene, j.bvh, j.cam)(
            jnp.asarray(pos[FRAME_PHASE]))),
        p_frame=_hits_np(pt.make_animated_renderer(p.scene, p.bvh, p.cam)(
            t_(pos[FRAME_PHASE]))))
    p3 = pt.deform_scene(p.scene, t_(pos[FRAME_PHASE])).triangles
    out.abc = tuple(n_(x)[:p.scene.count] for x in (p3.a, p3.b, p3.c))
    return out


def _config4_fixture():
    s = _config4()
    return {**encode_hits(s.j_frame.t != MAX_FLOAT, s.j_frame.tri),
            "refit_sha256": np.str_(bits_digest(s.j_refit.node_aabb_min, s.j_refit.node_aabb_max)),
            "refit_positions_sha256": np.str_(bits_digest(s.pos[REFIT_PHASE])),
            "frame_positions_sha256": np.str_(bits_digest(s.pos[FRAME_PHASE]))}


def test_config4_refit_and_karras_rebuild_bit_identical():
    s = _config4()
    for f in ("node_aabb_min", "node_aabb_max"):
        assert_same_bits(getattr(s.p_refit, f), getattr(s.j_refit, f), f"refit {f}")
    for f in _BVH_FIELDS:
        assert_same_bits(getattr(s.p_karras, f), getattr(s.j_karras, f), f"karras {f}")


def test_config4_animated_frame_under_the_crack_rule():
    s, p = _config4(), _port("config2")
    st = assert_hit_parity_at_scale(s.p_frame, s.j_frame, *s.abc, p.on, p.dn)
    assert st["divergent"] == [] and st["grazing_t"] == [146807], st
    assert st["tri_ties"] == 0 and st["hits"] + 1 == 80657, st


def test_config4_fixture_equals_jax():
    _fixture_equals_jax("config4", _config4_fixture())


# ---- config 3 (slow) --------------------------------------------------------

@pytest.mark.slow
def test_config3_trees_and_tables():
    """The Karras trees and tables bit-identical; the default (free-order
    SAH) trees differ only inside one subtree of six internal nodes, where a
    split falls otherwise, and in the four BVH4 records over it."""
    j, p = _jax("config3"), _port("config3")
    assert p.scene.count == 260642
    assert_same_bits(p.scene.morton, j.scene.morton, "morton")
    pk, jk = pt.build_bvh(p.scene, builder="karras"), rt.build_bvh(j.scene, builder="karras")
    for f in _BVH_FIELDS:
        assert_same_bits(getattr(pk, f), getattr(jk, f), f"karras {f}")
    assert_same_bits(pt4.prepare_tables4(p.scene, pk), jt4.prepare_tables4(j.scene, jk, pack=1),
                     "karras BVH4 table")
    rows = set()
    for f in _BVH_FIELDS:
        g, w = n_(getattr(p.bvh, f)), n_(getattr(j.bvh, f)).astype(n_(getattr(p.bvh, f)).dtype)
        rows |= set(np.flatnonzero((g != w).reshape(len(g), -1).any(axis=1)).tolist())
    assert sorted(rows) == [143278, 143280, 143281, 143282, 143283, 143287], sorted(rows)
    t4, j4 = n_(pt4.prepare_tables4(p.scene, p.bvh)), n_(jt4.prepare_tables4(j.scene, j.bvh, pack=1))
    assert t4.shape == j4.shape
    assert np.flatnonzero((t4 != j4).any(axis=1)).tolist() == [70560, 70564, 70565, 70566]


@pytest.mark.slow
def test_config3_shadow_masks_on_shared_rays():
    st = _shared_rule("config3")
    end = [473359, 477190, 481053, 481054, 484897, 502191, 510037, 511959, 521410, 529104,
           531187, 534749, 538546, 538724, 538876, 544491, 571149, 590322, 590323, 599900,
           613183, 613327, 653625, 682412, 686174]
    assert st["divergent"] == end + [1001725], st
    assert st["near_threshold"] == end, st
    # One crack: float64's blocker lies 4.66e-4 from an edge two triangles
    # share, within the edge bound there.
    assert st["edge_distance"][-1] == pytest.approx(4.66e-4, rel=1e-2), st
    assert st["agrees"].count("ref") == 15 and st["agrees"].count("got") == 11, st
    assert st["occluded"] == {"got": 12080, "ref": 12068}, st


@pytest.mark.slow
def test_config3_frames_under_the_frame_rule():
    st = _frame_rules("config3")
    assert st.hits["divergent"] == [463816, 582869, 682497, 809183, 855667, 956884, 1014266,
                                    1060878, 1122217, 1124269, 1148854, 1301057], st.hits
    assert len(st.hits["tie_rays"]) == 31, st.hits
    assert len(st.shadow_rays) == 50 and len(st.occ["near_threshold"]) == 36, st.occ
    assert st.occ["agrees"].count("neither") == 1, st.occ
    # 11 primary cracks, 20 exact-t tie flips and the pinned shadow flip.
    beyond = st.frame["beyond_1"]
    assert len(beyond) == 32 and st.frame["beyond_2"] == 26, st.frame
    assert len(set(beyond) & set(st.hits["divergent"])) == 11
    assert len(set(beyond) & set(st.hits["tie_rays"])) == 20
    assert set(beyond) & set(st.shadow_rays) == set()
    assert 542709 in beyond


@pytest.mark.slow
def test_config3_port_frame_is_deterministic_on_eight_threads():
    p = _port("config3")
    threads = torch.get_num_threads()
    torch.set_num_threads(8)
    try:
        tex = pt.solid_texture(TEX, device=CPU)
        frames = [pt.render_frame(p.scene, p.bvh, p.cam, tex, BG, shadows=True)
                  for _ in range(2)]
    finally:
        torch.set_num_threads(threads)
    parity.assert_bits_equal(n_(frames[0]), n_(frames[1]), "config-3 frame")


@pytest.mark.slow
def test_config3_fixture_equals_jax():
    _fixture_equals_jax("config3", _frame_fixture("config3"))


def write_fixtures(names=("config2", "config3", "config4")) -> None:
    """Write the JAX package's answers as the fixtures (config 3 takes a few
    minutes)."""
    for name in names:
        key, want = {"config2": ("config2_frame", lambda: _frame_fixture("config2")),
                     "config3": ("config3", lambda: _frame_fixture("config3")),
                     "config4": ("config4", _config4_fixture)}[name]
        np.savez_compressed(FIXTURES[key], **want())
        print(f"wrote {FIXTURES[key]} ({os.path.getsize(FIXTURES[key])} bytes)")


def repeat_config3_frames(reps: int, packages=("port", "jax")) -> None:
    """Render config 3's frame with shadows ``reps`` times per package, in
    turns (the port on every CPU thread), and print one JSON line a frame:
    its SHA-256 and how many pixels differ from the package's first frame.
    How the block of one eighth (ROADMAP queue 3) was looked for."""
    import json
    import time

    torch.set_num_threads(os.cpu_count())
    mesh_kw, cam_kw = CONFIG3
    render = {}
    if "port" in packages:
        ps = pt.build_scene(pt.terrain_mesh(**mesh_kw), device=CPU)
        args = (ps, pt.build_bvh(ps), pt.make_camera(**cam_kw, device=CPU),
                pt.solid_texture(TEX, device=CPU), BG)
        render["port"] = lambda: n_(pt.render_frame(*args, shadows=True))
    if "jax" in packages:
        js = rt.build_scene(rt.terrain_mesh(**mesh_kw))
        jargs = (js, rt.build_bvh(js), rt.make_camera(**cam_kw), rt.solid_texture(TEX), BG)
        render["jax"] = lambda: n_(rt.render_frame(*jargs, shadows=True))
    first = {}
    for rep in range(reps):
        for name, fn in render.items():
            t0 = time.perf_counter()
            frame = fn()
            first.setdefault(name, frame)
            off = np.flatnonzero((frame != first[name]).any(axis=-1).reshape(-1))
            print(json.dumps({
                "package": name, "rep": rep, "seconds": time.perf_counter() - t0,
                "sha256": bits_digest(frame), "pixels_differing_from_first": int(off.size),
                "rays": [int(off.min()), int(off.max())] if off.size else None}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["repeat"]:
        repeat_config3_frames(int(sys.argv[2]), tuple(sys.argv[3:]) or ("port", "jax"))
    else:
        write_fixtures(tuple(sys.argv[1:]) or ("config2", "config3", "config4"))
