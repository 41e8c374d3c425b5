"""K1's compressed-record variant in the port: `compress_tables4` against the
JAX package's (bit for bit), its outward rounding, and the plain 52-slot walk
against the JAX package's compressed kernel (``_make_kernel4(compress=True)``,
run in interpret mode on the CPU) under the parity contract.  The CUDA entry
point is held to the same plain walk on the card
(``tests/test_torch_kernel_gpu.py``, ``chip_smoke.py``)."""
import numpy as np
import pytest
import torch

import unitysimpleraytracing_tpu as rt
import unitysimpleraytracing_tpu_torch as pt
from unitysimpleraytracing_tpu.ops import trace_pallas4 as jt4
from unitysimpleraytracing_tpu_torch.ops import dispatch as pdispatch
from unitysimpleraytracing_tpu_torch.ops import trace_bvh4 as pt4
from unitysimpleraytracing_tpu_torch.utils.parity import assert_hit_parity, grazing_factor

from _torch_common import CPU, assert_same_bits, n_, rays, t_

# The two scenes of the JAX package's compressed-record test
# (tests/test_trace_pallas4.py::test_bvh4_compressed_records_parity).
_JAX_SCENES = {
    "soup300": (lambda m: m.random_triangle_soup(300, seed=7, bound=5.0, tri_size=1.0), 3),
    "terrain12": (lambda m: m.terrain_mesh(res=12, size=12.0, amplitude=3.0, seed=0), 5),
}


def _built(name):
    make, seed = _JAX_SCENES[name]
    js, ps = rt.build_scene(make(rt)), pt.build_scene(make(pt), device=CPU)
    return js, rt.build_bvh(js), ps, pt.build_bvh(ps), seed


@pytest.mark.parametrize("name", list(_JAX_SCENES))
def test_compress_tables4_bit_identical_to_jax(name):
    js, jb, ps, pb, _ = _built(name)
    plain = pt4.prepare_tables4(ps, pb)
    got = pt4.compress_tables4(plain)
    want = jt4.compress_tables4(jt4.pack_tables4(js, jb, pack=1, cap4=plain.shape[0]))
    assert tuple(got.shape) == (plain.shape[0], 52) and got.dtype == torch.float32
    assert_same_bits(got, want, "compressed table")
    # Metas and vertices move unchanged; boxes shrink to 12 slots.
    assert torch.equal(got[:, 12:].view(torch.int32), plain[:, 24:].view(torch.int32))


def _edge_table(special, seed):
    rng = np.random.default_rng(seed)
    table = rng.normal(scale=50.0, size=(64, 64)).astype(np.float32)
    table[:, :24] = np.where(rng.random((64, 24)) < 0.3,
                             rng.choice(np.asarray(special, np.float32), size=(64, 24)),
                             table[:, :24])
    return table


def test_compress_tables4_rounding_of_edge_values_matches_jax():
    """Negative, positive, exact-bf16, zero of both signs, the EMPTY
    entries' +-3e38 and infinities, in every box slot: bit for bit."""
    table = _edge_table([0.0, -0.0, 1.0, -1.0, 1.5, -2.75, 3.0e38, -3.0e38, np.inf,
                         -np.inf, 1.00390625, -1.00390625], seed=4)
    assert_same_bits(pt4.compress_tables4(t_(table)), jt4.compress_tables4(table),
                     "compressed table")


def test_compress_tables4_rounds_denormals_outward():
    """Float32 denormals are the one input where the port and the JAX
    package differ: XLA flushes them to zero in its sign test and so
    truncates a negative denormal min toward zero; the port rounds every
    value outward, as the contract says.  (No packed box holds a denormal:
    triangle boxes are inflated by 1e-3.)  Every other slot is identical."""
    table = _edge_table([1e-40, -1e-40, 0.0, -3.0], seed=5)
    got = n_(pt4.compress_tables4(t_(table)))
    want = np.asarray(jt4.compress_tables4(table))
    iv = got[:, :12].view(np.uint32)
    mn, mx = (iv & 0xFFFF0000).view(np.float32), (iv << 16).view(np.float32)
    box_denormal = np.zeros(got.shape, bool)
    for e in range(4):
        assert np.all(mn[:, 3 * e:3 * e + 3] <= table[:, 6 * e:6 * e + 3])
        assert np.all(mx[:, 3 * e:3 * e + 3] >= table[:, 6 * e + 3:6 * e + 6])
        src = np.abs(table[:, 6 * e:6 * e + 6])
        tiny = (src > 0) & (src < np.finfo(np.float32).tiny)
        box_denormal[:, 3 * e:3 * e + 3] = tiny[:, :3] | tiny[:, 3:]
    assert box_denormal.any()
    same = got.view(np.uint32) == want.view(np.uint32)
    assert same[~box_denormal].all()


def test_compressed_rounding_is_conservative():
    """Every stored bf16 box contains its float32 source box (the port of the
    JAX package's test of the same name)."""
    scene = pt.build_scene(pt.random_triangle_soup(200, seed=9, bound=7.0), device=CPU)
    bvh = pt.build_bvh(scene)
    plain = n_(pt4.prepare_tables4(scene, bvh))
    comp = n_(pt4.compress_tables4(t_(plain)))
    iv = comp[:, :12].view(np.uint32)
    mn = (iv & 0xFFFF0000).view(np.float32)
    mx = (iv << 16).view(np.float32)
    for e in range(4):
        assert np.all(mn[:, 3 * e:3 * e + 3] <= plain[:, 6 * e:6 * e + 3])
        assert np.all(mx[:, 3 * e:3 * e + 3] >= plain[:, 6 * e + 3:6 * e + 6])


@pytest.mark.parametrize("name", list(_JAX_SCENES))
def test_compressed_walk_vs_jax_compressed_kernel(name):
    """The plain 52-slot walk against the JAX package's compressed kernel in
    interpret mode, under the parity contract; and t, tri equal to the port's
    own uncompressed walk (widened boxes only admit extra slab passes, which
    the strict-< fold rejects), on the JAX package's two scenes."""
    js, jb, ps, pb, seed = _built(name)
    o, d = rays(1024, seed, bound=10.0)  # one packet of the JAX kernel
    plain = pt4.prepare_tables4(ps, pb)
    comp = pt4.compress_tables4(plain)
    want = jt4.traverse_packets_pallas4(
        js, jb, o, d, interpret=True,
        tables=jt4.compress_tables4(jt4.pack_tables4(js, jb, pack=1, cap4=plain.shape[0])))
    got, steps = pt4.traverse_bvh4(comp, t_(o), t_(d), count_steps=True)
    t = ps.triangles
    scale = grazing_factor(n_(t.a), n_(t.b), n_(t.c), d, np.asarray(want.tri))
    st = assert_hit_parity(got, want, uv_atol=1e-5, uv_scale=scale)
    assert st["hits"] > 50
    full, full_steps = pt4.traverse_bvh4(plain, t_(o), t_(d), count_steps=True)
    assert torch.equal(got.t, full.t) and torch.equal(got.tri, full.tri)
    assert_hit_parity(got, full, exact=True)
    assert bool((steps >= full_steps).all())  # wider boxes: never fewer pops


def test_trace_rays_takes_a_compressed_table():
    """``trace_rays(scene, bvh, o, d, tables=compress_tables4(...))`` is how
    a caller reaches the compressed variant, with t_init and any-hit; the
    CPU runs the plain walk and counts no launch."""
    js, jb, ps, pb, _ = _built("terrain12")
    comp = pt4.compress_tables4(pt4.prepare_tables4(ps, pb))
    assert pt4.table_geometry(comp) == comp.shape[0]
    o, d = (t_(x) for x in rays(1000, 8, bound=10.0))  # ragged: padded to warps
    before = (pt4.traverse_bvh4.launches, pt4.traverse_bvh4.compressed_launches)
    got = pdispatch.trace_rays(ps, pb, o, d, tables=comp)
    want = pdispatch.trace_rays(ps, pb, o, d)
    assert_hit_parity(got, want, exact=True)
    thr = torch.where(want.hit, want.t + 1.0, 0.0)
    a = pdispatch.trace_rays(ps, pb, o, d, tables=comp, anyhit_thresh=thr)
    b = pdispatch.trace_rays(ps, pb, o, d, anyhit_thresh=thr)
    assert torch.equal(a.hit & (a.t < thr), b.hit & (b.t < thr))
    seeded = pdispatch.trace_rays(ps, pb, o, d, tables=comp, t_init=want.t)
    assert torch.equal(seeded.t, want.t)
    assert (pt4.traverse_bvh4.launches, pt4.traverse_bvh4.compressed_launches) == before
    with pytest.raises(ValueError, match="52"):
        pt4.traverse_bvh4(torch.zeros((4, 53)), o[:32].contiguous(), d[:32].contiguous())
    with pytest.raises(ValueError, match="64"):
        pt4.compress_tables4(comp)
