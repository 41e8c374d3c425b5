"""Traversal modes and dispatch of the PyTorch port against the JAX package:
``t_init`` pruning, any-hit occlusion, the brute-force oracle, `occluded`,
batch padding, engine selection and the wrapper's input checks.  Same parity
contract as tests/test_torch_trace.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unitysimpleraytracing_tpu as rt
import unitysimpleraytracing_tpu_torch as pt
from unitysimpleraytracing_tpu.ops import dispatch as jdispatch
from unitysimpleraytracing_tpu.ops import trace as jtrace
from unitysimpleraytracing_tpu.ops import trace_pallas4 as jt4
from unitysimpleraytracing_tpu_torch.ops import dispatch as pdispatch
from unitysimpleraytracing_tpu_torch.ops import trace as ptrace
from unitysimpleraytracing_tpu_torch.ops import trace_bvh4 as pt4
from unitysimpleraytracing_tpu_torch.utils.parity import assert_hit_parity

from _torch_common import CPU, both_built, n_, rays, t_

MAXF = np.float32(rt.constants.MAX_FLOAT)


def _soup200(seed):
    def make(m):
        return m.random_triangle_soup(200, seed=seed, bound=5.0, tri_size=1.0)

    js, ps = rt.build_scene(make(rt)), pt.build_scene(make(pt), device=CPU)
    return (js, rt.build_bvh(js, builder="karras"),
            ps, pt.build_bvh(ps, builder="karras"))


def test_t_init_pruning_exact():
    js, jb, ps, pb = _soup200(5)
    o, d = rays(1024, seed=4)
    table = pt4.prepare_tables4(ps, pb)
    ref = jtrace.traverse(js, jb, jnp.asarray(o), jnp.asarray(d))
    t_ref = np.asarray(ref.t)
    # Additive margin: t can be NEGATIVE (no t>0 test), so a multiplicative
    # 1.01 would move the wrong way.
    eps = np.float32(0.01) * np.maximum(np.abs(t_ref), 1.0).astype(np.float32)
    above = np.where(t_ref < 1e30, t_ref + eps, MAXF).astype(np.float32)
    got = pt4.traverse_bvh4_plain(table, t_(o), t_(d), t_init=t_(above))
    assert_hit_parity(got, ref, uv_atol=1e-5)
    below = np.where(t_ref < 1e30, t_ref - eps, MAXF).astype(np.float32)
    got2 = pt4.traverse_bvh4_plain(table, t_(o), t_(d), t_init=t_(below))
    assert not np.any(n_(got2.t) < below)


def test_anyhit_occlusion_boolean_identical():
    js, jb, ps, pb = _soup200(8)
    o, d = rays(1024, seed=6)
    table = pt4.prepare_tables4(ps, pb)
    thr = np.full((1024,), 20.0, np.float32)
    ref = jtrace.traverse(js, jb, jnp.asarray(o), jnp.asarray(d))
    want = np.asarray(ref.hit) & (np.asarray(ref.t) < 20.0)
    got, steps_any = pt4.traverse_bvh4_plain(
        table, t_(o), t_(d), anyhit_thresh=t_(thr), count_steps=True)
    have = n_(got.hit) & (n_(got.t) < 20.0)
    np.testing.assert_array_equal(have, want)
    jgot = jt4.traverse_packets_pallas4(
        js, jb, jnp.asarray(o), jnp.asarray(d), interpret=True,
        anyhit_thresh=jnp.asarray(thr))
    np.testing.assert_array_equal(
        have, np.asarray(jgot.hit) & (np.asarray(jgot.t) < 20.0))
    assert want.any() and not want.all()
    # Early exit: never more pops than the nearest-hit walk, fewer somewhere.
    _, steps_near = pt4.traverse_bvh4_plain(table, t_(o), t_(d), count_steps=True)
    assert bool((steps_any <= steps_near).all()) and bool((steps_any < steps_near).any())
    assert np.all(n_(got.t)[have] == 0.0)


def test_port_traverse_vs_brute_force_tie_free():
    _, _, ps, pb = _soup200(5)
    o, d = rays(512, seed=11)
    ref = ptrace.brute_force_trace(ps, t_(o), t_(d), chunk=64)
    got = ptrace.traverse(ps, pb, t_(o), t_(d))
    for f in ("t", "tri", "u", "v"):
        np.testing.assert_array_equal(n_(getattr(got, f)), n_(getattr(ref, f)))
    # ... and the brute force itself against the JAX one-triangle-at-a-time loop.
    js = rt.build_scene(rt.random_triangle_soup(200, seed=5, bound=5.0, tri_size=1.0))
    jref = jtrace.brute_force_trace(js, jnp.asarray(o), jnp.asarray(d))
    assert_hit_parity(ref, jref, uv_atol=1e-5)
    np.testing.assert_array_equal(n_(ref.tri), np.asarray(jref.tri))


def test_brute_force_lowest_id_wins_equal_t():
    """Two coincident triangles: the lower id wins, whatever the chunking."""
    mesh = pt.cube_mesh(size=2.0)
    pos = np.concatenate([mesh.positions, mesh.positions])
    dup = pt.MeshData(positions=pos, uvs=np.concatenate([mesh.uvs] * 2),
                      normals=np.concatenate([mesh.normals] * 2))
    ps = pt.build_scene(dup, device=CPU)
    o, d = rays(256, seed=2, bound=4.0)
    for chunk in (5, 12, 1024):
        h = ptrace.brute_force_trace(ps, t_(o), t_(d), chunk=chunk)
        assert bool(h.hit.any()) and bool((h.tri[h.hit] < 12).all())


def test_occluded_boolean_identical_to_jax():
    js, jb, ps, pb = both_built("terrain20")
    o, d = rays(1024, seed=3, bound=10.0)
    want = np.asarray(jdispatch.occluded(js, jb, jnp.asarray(o), jnp.asarray(d), impl="pallas4"))
    got = n_(pdispatch.occluded(ps, pb, t_(o), t_(d)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        n_(pdispatch.occluded(ps, pb, t_(o), t_(d), impl="perray")), want)
    assert want.any() and not want.all()


def test_trace_rays_pads_ragged_batches():
    _, _, ps, pb = both_built("soup300")
    o, d = rays(1000, seed=13)  # not a multiple of the kernel's ray multiple
    assert 1000 % pt4.RAY_MULTIPLE
    full = pdispatch.trace_rays(ps, pb, t_(o), t_(d))
    ref = ptrace.traverse(ps, pb, t_(o), t_(d))
    assert full.t.shape == (1000,)
    assert_hit_parity(full, ref, exact=True)
    thr = t_(np.full((1000,), 5.0, np.float32))
    t0 = t_(np.full((1000,), 7.0, np.float32))
    h = pdispatch.trace_rays(ps, pb, t_(o), t_(d), t_init=t0, anyhit_thresh=thr)
    assert h.t.shape == (1000,)
    assert bool((h.t <= 7.0).all())
    by_name = pdispatch.trace_rays(ps, pb, t_(o), t_(d), impl="plain4")
    assert torch.equal(by_name.t, full.t) and torch.equal(by_name.tri, full.tri)
    with pytest.raises(ValueError, match="unknown traversal impl"):
        pdispatch.trace_rays(ps, pb, t_(o), t_(d), impl="pallas4")


def test_resolve_impl_and_capacity_envelope():
    assert pdispatch.resolve_impl("auto", 1024, "cpu") == "plain4"
    assert pdispatch.resolve_impl("auto", 1024, "cuda:0") == "cuda4"
    assert pdispatch.resolve_impl("perray", 1 << 22, "cpu") == "perray"
    assert pdispatch.resolve_impl("plain4", pdispatch.MAX_CAPACITY, "cpu") == "plain4"
    assert issubclass(pdispatch.CapacityError, ValueError)
    for impl in ("auto", "cuda4", "plain4"):
        with pytest.raises(pdispatch.CapacityError, match="chunked"):
            pdispatch.resolve_impl(impl, 1 << 21, "cuda")


def test_tile_major_round_trip_matches_jax():
    x = np.arange(64 * 96 * 3, dtype=np.float32).reshape(64 * 96, 3)
    got = pdispatch._tile_major(t_(x), 64, 96, 32)
    np.testing.assert_array_equal(n_(got), np.asarray(jdispatch._tile_major(x, 64, 96, 32)))
    assert torch.equal(pdispatch._row_major(got, 64, 96, 32), t_(x))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    _, _, ps, pb = both_built("cube")
    table = pt4.prepare_tables4(ps, pb)
    o, d = (t_(x) for x in rays(64, seed=1))
    with pytest.raises(TypeError, match="float32"):
        pt4.traverse_bvh4(table, o.double(), d)
    with pytest.raises(ValueError, match="shape"):
        pt4.traverse_bvh4(table, o, d[:32])
    with pytest.raises(ValueError, match="contiguous"):
        pt4.traverse_bvh4(table, o.T.contiguous().T, d)
    with pytest.raises(ValueError, match="shape"):
        pt4.traverse_bvh4(table, o, d, t_init=torch.zeros(63))
    with pytest.raises(ValueError, match="record table"):
        pt4.traverse_bvh4(table[:, :32].contiguous(), o, d)
    with pytest.raises(ValueError, match="empty"):
        pt4.traverse_bvh4(table, o[:0], d[:0])
