"""Binary-record traversal of the PyTorch port against the JAX package.

The port's record table is held bit for bit against the JAX
``trace_pallas.pack_tables(pack=1)``; the port's plain binary-record traversal
against the JAX Pallas kernel in interpret mode on the same numpy rays, under
the parity contract: identical hit masks; t within rtol=4e-6; tri mismatches
only at exact-t ties; u, v within 1e-5 · max(1, 0.1/|det|) where tri agrees
(XLA:CPU fuses multiply-adds that eager PyTorch keeps apart, and the quotient
by det amplifies that on grazing rays — see tests/test_torch_trace.py).

The JAX kernel orders a record's children by a per-packet vote of direction
signs, the port by each ray's own sign: that moves only which of two exactly
tied triangles wins, which the contract covers.

Every JAX kernel call below has ONE shape (2 packets, capacity 1024, pack=1,
popn=1, t_init and threshold always passed), so interpret mode compiles once.
"""
import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unitysimpleraytracing_tpu as rt
import unitysimpleraytracing_tpu_torch as pt
from unitysimpleraytracing_tpu.ops import trace_pallas as jt2
from unitysimpleraytracing_tpu_torch.io import convert
from unitysimpleraytracing_tpu_torch.ops import dispatch as pdispatch
from unitysimpleraytracing_tpu_torch.ops import trace as ptrace
from unitysimpleraytracing_tpu_torch.ops import trace_bvh2 as pt2
from unitysimpleraytracing_tpu_torch.ops import trace_bvh4 as pt4
from unitysimpleraytracing_tpu_torch.utils.parity import assert_hit_parity, grazing_factor

from _torch_common import CPU, assert_same_bits, both_built, n_, rays, t_

MAXF = np.float32(rt.constants.MAX_FLOAT)
N_RAYS = 2048

# scene name -> (ray seed, ray bound); all three have capacity 1024.
_CASES = {"cube": (2, 4.0), "soup300": (3, 8.0), "terrain20": (9, 14.0)}


def _jax_kernel(js, jb, o, d, t_init=None, thresh=None):
    n = o.shape[0]
    assert n == N_RAYS and jb.capacity == 1024
    t_init = np.full((n,), MAXF, np.float32) if t_init is None else t_init
    thresh = np.zeros((n,), np.float32) if thresh is None else thresh
    return jt2.traverse_packets_pallas(
        js, jb, jnp.asarray(o), jnp.asarray(d), interpret=True, pack=1, popn=1,
        t_init=jnp.asarray(t_init), anyhit_thresh=jnp.asarray(thresh))


def _uv_scale(ps, d, tri):
    t = ps.triangles
    return grazing_factor(n_(t.a), n_(t.b), n_(t.c), d, np.asarray(tri))


# ---- the record table ------------------------------------------------------


@pytest.mark.parametrize("name", ["cube", "soup300", "soup300_dups", "terrain20", "terrain48"])
def test_pack_tables_bit_identical_to_jax(name):
    js, jb, ps, pb = both_built(name)
    want = np.asarray(jt2.pack_tables(js, jb, pack=1))
    got = pt2.pack_tables(ps, pb)
    assert tuple(got.shape) == (pb.capacity, 32) and got.dtype == torch.float32
    assert_same_bits(got, want, "table")
    # ... and from the JAX-built scene and tree carried across as numpy.
    carried = pt2.pack_tables(
        convert.scene_from_numpy(js, device=CPU), convert.bvh_from_numpy(jb, device=CPU))
    assert_same_bits(carried, want, "table from carried state")
    assert torch.equal(convert.table_from_numpy(want, device=CPU), got)


@pytest.mark.parametrize("pack", [2, 4])
def test_packed_views_are_reshapes_of_the_same_bytes(pack):
    js, jb, ps, pb = both_built("soup300")
    flat = pt2.pack_tables(ps, pb, pack=1)
    view = pt2.pack_tables(ps, pb, pack=pack)
    assert tuple(view.shape) == (pb.capacity // pack, pack * 32)
    assert torch.equal(view.reshape(-1, 32), flat)
    assert_same_bits(view, np.asarray(jt2.pack_tables(js, jb, pack=pack)), f"pack={pack}")
    # The traversal takes the flat form only: 64 slots per row is a BVH4 table.
    o, d = (t_(x) for x in rays(64, seed=1))
    with pytest.raises(ValueError, match="reshape"):
        pt2.traverse_bvh2(view, o, d)
    with pytest.raises(ValueError, match="pack must be"):
        pt2.pack_tables(ps, pb, pack=3)


def test_boxes_widen_beyond_extent_8192_and_by_zero_within():
    def big(m):
        return m.terrain_mesh(res=24, size=50000.0, amplitude=7000.0, seed=2)

    js, ps = rt.build_scene(big(rt)), pt.build_scene(big(pt), device=CPU)
    jb, pb = rt.build_bvh(js, builder="karras"), pt.build_bvh(ps, builder="karras")
    got = pt2.pack_tables(ps, pb)
    assert_same_bits(got, np.asarray(jt2.pack_tables(js, jb, pack=1)), "widened table")
    lc = int(pb.left[0])
    assert not bool(pb.left_is_leaf[0])
    assert bool((got[0, 0:3] < pb.node_aabb_min[lc]).all())
    assert bool((got[0, 3:6] > pb.node_aabb_max[lc]).all())
    # Hit parity at that extent against the port's oracle (no cull there).
    o, d = rays(1024, seed=5, bound=35000.0)
    want = ptrace.traverse(ps, pb, t_(o), t_(d))
    assert_hit_parity(pt2.traverse_bvh2_plain(got, t_(o), t_(d)), want, exact=True)
    assert bool(want.hit.any())
    # Within the bound the packed boxes are the child boxes bit for bit.
    _, _, ss, sb = both_built("cube")
    tab = pt2.pack_tables(ss, sb)
    lc = int(sb.left[0])
    box = ss.aabb_min[int(sb.sorted_tri[lc])] if bool(sb.left_is_leaf[0]) else sb.node_aabb_min[lc]
    assert torch.equal(tab[0, 0:3], box)


def test_auto_pack_and_resolve_pack():
    # One fetch form on this card: one record per row whatever the capacity
    # (the JAX thresholds size a TPU's fast memory).
    for cap in (1024, 170_001, 340_001, 600_000):
        assert pt2.auto_pack(cap) == 1
    assert jt2.auto_pack(340_001) == 4
    assert pt2._resolve_pack(1024, None, None) == 1
    for flat, pack, want in ((True, None, 1), (False, None, 4), (True, 2, 2), (None, 4, 4)):
        assert pt2._resolve_pack(1024, flat, pack) == want
        assert jt2._resolve_pack(1024, flat, pack) == want
    with pytest.raises(ValueError, match="pack must be"):
        pt2._resolve_pack(1022, None, 4)


def test_prepare_tables_cache_engages_and_evicts():
    _, _, ps, pb = both_built("cube")
    t1 = pt2.prepare_tables(ps, pb)
    assert pt2.prepare_tables(ps, pb) is t1, "cache miss on identical (scene, bvh)"
    # Whatever layout is asked for, the table is the flat one the kernel takes.
    assert pt2.prepare_tables(ps, pb, pack=4) is t1
    assert pt2.prepare_tables(ps, pb, flat=False) is t1
    key = id(pb)
    assert key in pt2._TABLE_CACHE
    # A different scene with the same bvh must not serve the stale entry.
    ps2 = pt.build_scene(pt.cube_mesh(size=2.0), device=CPU)
    t3 = pt2.prepare_tables(ps2, pb)
    assert t3 is not t1 and torch.equal(t3, t1)
    del pb
    gc.collect()
    assert key not in pt2._TABLE_CACHE, "dead Bvh entry not evicted"


def test_capacity_envelope_is_two_to_the_twenty():
    assert pt2.MAX_CAPACITY == (1 << 20) - 1
    assert pdispatch.resolve_impl("plain2", (1 << 20) - 1024, "cpu") == "plain2"
    for impl in ("plain2", "cuda2"):
        with pytest.raises(pdispatch.CapacityError, match="cuda4"):
            pdispatch.resolve_impl(impl, 1 << 20, "cpu")
    assert pdispatch.resolve_impl("plain4", 1 << 20, "cpu") == "plain4"
    assert pdispatch.resolve_impl("packet", 1 << 22, "cpu") == "packet"


# ---- traversal -------------------------------------------------------------


@pytest.fixture(scope="module", params=sorted(_CASES))
def traced(request):
    """One scene traced by the binary-record engines of both packages and by
    the port's other engines, on the same rays."""
    name = request.param
    seed, bound = _CASES[name]
    js, jb, ps, pb = both_built(name)
    o, d = rays(N_RAYS, seed, bound)
    table = pt2.prepare_tables(ps, pb)
    plain2, steps = pt2.traverse_bvh2_plain(table, t_(o), t_(d), count_steps=True)
    jax_kernel = _jax_kernel(js, jb, o, d)
    return {
        "scene": (js, jb, ps, pb), "rays": (o, d), "table": table,
        "plain2": plain2, "steps": steps, "jax_kernel": jax_kernel,
        "uv_scale": _uv_scale(ps, d, jax_kernel.tri),
        "plain4": pt4.traverse_bvh4_plain(pt4.prepare_tables4(ps, pb), t_(o), t_(d)),
        "perray": ptrace.traverse(ps, pb, t_(o), t_(d)),
    }


def test_plain2_vs_jax_kernel_interpret_mode(traced):
    st = assert_hit_parity(
        traced["plain2"], traced["jax_kernel"], uv_atol=1e-5, uv_scale=traced["uv_scale"])
    assert st["hits"] > 0


def test_plain2_vs_port_perray_and_plain4(traced):
    """Same float32 operations in all three port engines (the binary record
    differences its vertices in the traversal, the BVH4 record at pack time:
    the same IEEE subtraction): t, u, v bit-identical wherever the winning
    triangle agrees."""
    assert_hit_parity(traced["plain2"], traced["perray"], exact=True)
    assert_hit_parity(traced["plain2"], traced["plain4"], exact=True)


def test_wrapper_on_cpu_is_the_plain_version_and_dispatch_reaches_it(traced):
    _, _, ps, pb = traced["scene"]
    o, d = (t_(x) for x in traced["rays"])
    before = pt2.traverse_bvh2.launches
    got, steps = pt2.traverse_bvh2(traced["table"], o, d, count_steps=True)
    assert pt2.traverse_bvh2.launches == before == 0
    by_name = pdispatch.trace_rays(ps, pb, o, d, impl="plain2")
    for f in ("t", "tri", "u", "v"):
        assert torch.equal(getattr(got, f), getattr(traced["plain2"], f))
        assert torch.equal(getattr(by_name, f), getattr(traced["plain2"], f))
    assert torch.equal(steps, traced["steps"])
    assert steps.dtype == torch.int32 and int(steps.min()) >= 1


def test_misses_report_tri_zero_and_max_float(traced):
    h = traced["plain2"]
    miss = ~n_(h.hit)
    assert miss.any()
    assert np.all(n_(h.tri)[miss] == 0) and np.all(n_(h.t)[miss] == MAXF)
    assert np.all(n_(h.u)[miss] == 0) and np.all(n_(h.v)[miss] == 0)


def test_t_init_culling_is_exact(traced):
    """Re-traced with their own previous t as t_init, rays return no new hit
    (every strict-< accept fails, so t == t_init); a bound just above keeps
    every hit; the JAX kernel seeded the same way agrees."""
    js, jb, _, _ = traced["scene"]
    o, d = traced["rays"]
    table, ref = traced["table"], traced["plain2"]
    again = pt2.traverse_bvh2_plain(table, t_(o), t_(d), t_init=ref.t.clone())
    assert torch.equal(again.t, ref.t)
    assert bool((again.tri == 0).all())  # nothing was accepted
    t_ref = n_(ref.t)
    eps = np.float32(0.01) * np.maximum(np.abs(t_ref), 1.0).astype(np.float32)
    with np.errstate(over="ignore"):  # misses sit at MAX_FLOAT
        above = np.where(t_ref < 1e30, t_ref + eps, MAXF).astype(np.float32)
    got = pt2.traverse_bvh2_plain(table, t_(o), t_(d), t_init=t_(above))
    assert_hit_parity(got, ref, exact=True)
    below = np.where(t_ref < 1e30, t_ref - eps, MAXF).astype(np.float32)
    got_below, steps_below = pt2.traverse_bvh2_plain(
        table, t_(o), t_(d), t_init=t_(below), count_steps=True)
    assert not np.any(n_(got_below.t) < below)
    assert bool((steps_below <= traced["steps"]).all())
    jgot = _jax_kernel(js, jb, o, d, t_init=above)
    hit = t_ref < 1e30
    np.testing.assert_allclose(np.asarray(jgot.t)[hit], n_(got.t)[hit], rtol=4e-6)
    np.testing.assert_array_equal(np.asarray(jgot.t)[~hit], n_(got.t)[~hit])


def test_anyhit_boolean_equals_nearest_hit_boolean(traced):
    js, jb, _, _ = traced["scene"]
    o, d = traced["rays"]
    table, ref = traced["table"], traced["plain2"]
    t_ref = n_(ref.t)
    limit = np.float32(np.median(t_ref[t_ref < 1e30]))
    thr = np.full((N_RAYS,), limit, np.float32)
    want = n_(ref.hit) & (t_ref < limit)
    got, steps = pt2.traverse_bvh2_plain(
        table, t_(o), t_(d), anyhit_thresh=t_(thr), count_steps=True)
    have = n_(got.hit) & (n_(got.t) < limit)
    np.testing.assert_array_equal(have, want)
    assert want.any() and not want.all()
    assert np.all(n_(got.t)[have] == 0.0)
    # Early exit: never more pops than the nearest-hit walk.
    assert bool((steps <= traced["steps"]).all())
    # An inert (zero) threshold changes nothing.
    inert = pt2.traverse_bvh2_plain(
        table, t_(o), t_(d), anyhit_thresh=torch.zeros(N_RAYS))
    assert torch.equal(inert.t, ref.t) and torch.equal(inert.tri, ref.tri)
    jgot = _jax_kernel(js, jb, o, d, thresh=thr)
    np.testing.assert_array_equal(
        have, np.asarray(jgot.hit) & (np.asarray(jgot.t) < limit))


def test_shared_edge_ties_bounded():
    """Rays aimed exactly at cube edges and corners — the tie-heavy worst case."""
    js, jb, ps, pb = both_built("cube")
    targets = np.array(
        [[1, 1, 1], [1, 1, -1], [-1, -1, -1], [1, 1, 0], [0, 1, 1], [1, 0, 1],
         [1, 0, 0], [0, 0, 1], [0, 1, 0]], np.float32)
    eye = np.array([4.0, 3.0, 5.0], np.float32)
    d9 = targets - eye
    d9 /= np.linalg.norm(d9, axis=1, keepdims=True)
    reps = -(-N_RAYS // 9)
    d = np.tile(d9, (reps, 1))[:N_RAYS].astype(np.float32)
    o = np.broadcast_to(eye, d.shape).astype(np.float32).copy()
    got = pt2.traverse_bvh2_plain(pt2.prepare_tables(ps, pb), t_(o), t_(d))
    want = _jax_kernel(js, jb, o, d)
    assert np.all(n_(got.t) != MAXF)
    np.testing.assert_allclose(n_(got.t), np.asarray(want.t), rtol=4e-6)
    assert_hit_parity(got, ptrace.traverse(ps, pb, t_(o), t_(d)), exact=True)


def test_occluded_through_plain2_matches_the_other_engines():
    _, _, ps, pb = both_built("terrain20")
    o, d = rays(1000, seed=3, bound=10.0)  # ragged: padded to a warp
    want = pdispatch.occluded(ps, pb, t_(o), t_(d), impl="perray")
    got = pdispatch.occluded(ps, pb, t_(o), t_(d), impl="plain2")
    assert torch.equal(got, want)
    assert torch.equal(pdispatch.occluded(ps, pb, t_(o), t_(d), impl="plain4"), want)
    assert bool(want.any()) and not bool(want.all())
    seeded = pdispatch.trace_rays(
        ps, pb, t_(o), t_(d), impl="plain2",
        t_init=torch.full((1000,), 7.0), anyhit_thresh=torch.full((1000,), 5.0))
    assert seeded.t.shape == (1000,) and bool((seeded.t <= 7.0).all())


def test_tables_of_the_other_format_are_refused():
    _, _, ps, pb = both_built("cube")
    o, d = (t_(x) for x in rays(64, seed=1))
    t2, t4 = pt2.prepare_tables(ps, pb), pt4.prepare_tables4(ps, pb)
    with pytest.raises(ValueError, match="record table"):
        pdispatch.trace_rays(ps, pb, o, d, impl="plain2", tables=t4)
    with pytest.raises(ValueError, match="record table"):
        pdispatch.trace_rays(ps, pb, o, d, impl="plain4", tables=t2)
    with pytest.raises(TypeError, match="float32"):
        pt2.traverse_bvh2(t2, o.double(), d)
    with pytest.raises(ValueError, match="shape"):
        pt2.traverse_bvh2(t2, o, d, anyhit_thresh=torch.zeros(63))
    with pytest.raises(ValueError, match="contiguous"):
        pt2.traverse_bvh2(t2, o.T.contiguous().T, d)
    with pytest.raises(ValueError, match="empty"):
        pt2.traverse_bvh2(t2, o[:0], d[:0])
    with pytest.raises(ValueError, match="float32"):
        convert.table_from_numpy(np.zeros((4, 32), np.float64), device=CPU)
    with pytest.raises(ValueError, match="record table"):
        convert.table_from_numpy(np.zeros((4, 128), np.float32), device=CPU)
