"""Parity of the port's large-scene path (parallel/dist partition,
pipeline/chunked build, trace and frames) with the JAX package's, on small
scenes and chunk capacities of 128 to 1024 triangles.

Partition arrays, per-chunk trees and chunk tables are held bit for bit; hit
records to the parity contract (identical hit masks, t within 4e-6 relative,
a triangle id may differ only at an exact-t tie, which between chunks is the
tie the chunk traced first wins); frames to ``tests/test_golden.py::_compare``
(more than 2/255 off on fewer than 0.2 % of values).  On the CPU the JAX
package traces its chunks with its own CPU engine (``impl="auto"``) and the
port with the plain versions of its kernels."""
import numpy as np
import pytest
import torch

import unitysimpleraytracing_tpu as rt
import unitysimpleraytracing_tpu_torch as pt
from unitysimpleraytracing_tpu.parallel import dist as jdist
from unitysimpleraytracing_tpu_torch.ops import dispatch as pdispatch
from unitysimpleraytracing_tpu_torch.parallel import dist as pdist
from unitysimpleraytracing_tpu_torch.pipeline import chunked as pchunked
from unitysimpleraytracing_tpu_torch.utils.parity import (
    assert_hit_parity, compare_images, frame_to_uint8, grazing_factor,
)

from _torch_common import CPU, assert_fields_same_bits, assert_same_bits, n_, rays, t_

_SCENES = {
    "terrain16": lambda m: m.terrain_mesh(res=16, size=16.0, amplitude=3.0, seed=1),
    "soup1500": lambda m: m.random_triangle_soup(1500, seed=8, bound=10.0, tri_size=0.8),
}


def _scenes(name):
    make = _SCENES[name]
    return rt.build_scene(make(rt)), pt.build_scene(make(pt), device=CPU)


def _vs_jax(got, want, ps, d):
    """The parity contract against the JAX package's hits; u, v within 1e-5
    times the grazing factor (XLA:CPU fuses multiply-adds that the port
    keeps apart)."""
    t = ps.triangles
    scale = grazing_factor(n_(t.a), n_(t.b), n_(t.c), d, np.asarray(want.tri))
    return assert_hit_parity(got, want, uv_atol=1e-5, uv_scale=scale)


@pytest.fixture(scope="module")
def soup():
    """(jax scene, port scene, jax chunked "sah" bvh4, port chunked) at
    chunk_capacity 512: 3 chunks."""
    js, ps = _scenes("soup1500")
    jc = rt.build_bvh_chunked(js, chunk_capacity=512)
    pc = pt.build_bvh_chunked(ps, chunk_capacity=512)
    return js, ps, jc, pc


@pytest.mark.parametrize("balance", ["count", "area"])
@pytest.mark.parametrize("name", ["terrain16", "soup1500"])
def test_partition_bit_identical_to_jax(name, balance):
    js, ps = _scenes(name)
    want = jdist.partition_scene(js, 3, balance=balance)
    got = pdist.partition_scene(ps, 3, balance=balance)
    assert got.num_shards == 3 and got.shard_capacity == want.shard_capacity
    assert got.morton.dtype == torch.int64
    assert_fields_same_bits(got, want)
    # Padding rows: key 0xFFFFFFFF, degenerate (zero) geometry.
    counts = n_(got.counts)
    for s in range(3):
        assert bool((got.morton[s, counts[s]:] == 0xFFFFFFFF).all())
        assert not bool(got.tri_a[s, counts[s]:].any())


def test_partition_pads_an_empty_shard_with_an_inverted_box():
    """More shards than a count split can fill (12 triangles, 5 shards of
    ceil(12/5) = 3): the empty tail shard gets the inverted root box, as in
    the JAX package."""
    js, ps = rt.build_scene(rt.cube_mesh()), pt.build_scene(pt.cube_mesh(), device=CPU)
    want = jdist.partition_scene(js, 5)
    got = pdist.partition_scene(ps, 5)
    assert_fields_same_bits(got, want)
    empty = n_(got.counts) == 0
    assert empty.any()
    assert np.isinf(n_(got.range_min)[empty]).all()


@pytest.mark.parametrize("record_format", ["bvh4", "bvh2"])
@pytest.mark.parametrize("builder", ["karras", "sah", "sah_free"])
def test_chunk_trees_and_tables_bit_identical_to_jax(builder, record_format):
    js, ps = _scenes("terrain16")
    want = rt.build_bvh_chunked(js, chunk_capacity=128, builder=builder,
                                record_format=record_format)
    got = pt.build_bvh_chunked(ps, chunk_capacity=128, builder=builder,
                               record_format=record_format)
    assert got.num_chunks == want.num_chunks == 4
    assert got.capacity == want.capacity and got.bvhs.count == want.bvhs.count
    assert_fields_same_bits(got.sscene, want.sscene)
    assert_fields_same_bits(got.bvhs, want.bvhs)
    assert tuple(got.tables.shape) == tuple(want.tables.shape)
    assert got.tables.shape[-1] == {"bvh4": 64, "bvh2": 32}[record_format]
    assert_same_bits(got.tables, want.tables, "tables")


def test_default_builder_is_sah():
    _, ps = _scenes("terrain16")
    default = pt.build_bvh_chunked(ps, chunk_capacity=128)
    sah = pt.build_bvh_chunked(ps, chunk_capacity=128, builder="sah")
    assert torch.equal(default.tables, sah.tables)
    assert torch.equal(default.bvhs.left, sah.bvhs.left)


@pytest.mark.parametrize("route", [True, False])
def test_trace_chunked_vs_jax(soup, route):
    js, ps, jc, pc = soup
    o, d = rays(1024, 9, bound=12.0)
    want = rt.trace_chunked(jc, o, d)
    got = pt.trace_chunked(pc, t_(o), t_(d), route=route)
    st = _vs_jax(got, want, ps, d)
    assert st["hits"] > 100
    # And against the port's single tree (the same scene, one BVH).
    one = pt.build_bvh(ps, builder="sah")
    assert_hit_parity(got, pdispatch.trace_rays(ps, one, t_(o), t_(d)), uv_atol=1e-5)
    assert bool((got.tri[~got.hit] == 0).all())  # a miss carries triangle 0


def _uv_float64(ps, o, d, tri):
    """Möller–Trumbore u, v of triangle ``tri[r]`` under ray r, in float64."""
    t = ps.triangles
    a, b, c = (n_(x).astype(np.float64)[tri] for x in (t.a, t.b, t.c))
    o, d = o.astype(np.float64), d.astype(np.float64)
    e1, e2 = b - a, c - a
    p = np.cross(d, e2)
    det = np.einsum("ij,ij->i", e1, p)
    s = o - a
    return np.einsum("ij,ij->i", s, p) / det, np.einsum("ij,ij->i", d, np.cross(s, e1)) / det


def test_trace_chunked_binary_records_vs_jax(soup):
    """Binary chunk records: hits to the JAX package's under the contract, u
    and v included, and t, u, v bit for bit to the port's BVH4 chunks (both
    formats difference the same vertices with the same float32 operations).

    u, v are held to JAX's within 2e-5 times the grazing factor, twice
    `_vs_jax`'s 1e-5: on these rays one hit's v (det 0.137, origin 9.1 from
    the triangle) is 1.0088e-5 from JAX's, and a float64 recomputation puts
    the port's 4.1e-6 and JAX's 6.0e-6 from it, on either side (the XLA:CPU
    multiply-add).  So each side is held to float64 within 1e-5, and their
    difference to the sum of the two."""
    js, ps, jc, pc = soup
    pc2 = pt.build_bvh_chunked(ps, chunk_capacity=512, record_format="bvh2")
    o, d = rays(1024, 11, bound=12.0)
    want = rt.trace_chunked(jc, o, d)
    got = pt.trace_chunked(pc2, t_(o), t_(d))
    t = ps.triangles
    tri = n_(got.tri)
    scale = grazing_factor(n_(t.a), n_(t.b), n_(t.c), d, tri)
    st = assert_hit_parity(got, want, uv_atol=2e-5, uv_scale=scale)
    assert st["hits"] > 100
    same = n_(got.hit) & (tri == np.asarray(want.tri))
    for name, uv64 in zip(("u", "v"), _uv_float64(ps, o, d, tri)):
        for side, h in (("port", got), ("jax", want)):
            err = np.abs(n_(getattr(h, name)) - uv64)[same] / scale[same]
            assert err.max() <= 1e-5, (name, side, err.max())
    assert_hit_parity(got, pt.trace_chunked(pc, t_(o), t_(d)), exact=True)


def test_route_and_compact_equal_the_plain_fold(soup):
    """Routing reorders rays and compaction re-packs the live ones; both
    leave every ray's candidates and fold as they were: bit-identical."""
    _, _, _, pc = soup
    o, d = (t_(x) for x in rays(1000, 21, bound=15.0))  # ragged: not whole warps
    base = pt.trace_chunked(pc, o, d, route=False, compact=None)
    for route, compact in ((True, None), (False, 0), (False, 1), (True, 1), (False, "auto")):
        got = pt.trace_chunked(pc, o, d, route=route, compact=compact)
        for f in ("t", "tri", "u", "v"):
            assert torch.equal(getattr(got, f), getattr(base, f)), (route, compact, f)
    thr = torch.full((o.shape[0],), 10.0)
    a0 = pt.trace_chunked(pc, o, d, compact=None, anyhit_thresh=thr)
    a1 = pt.trace_chunked(pc, o, d, compact=1, anyhit_thresh=thr)
    assert torch.equal(a0.t, a1.t) and torch.equal(a0.tri, a1.tri)
    with pytest.raises(ValueError, match="out of range"):
        pt.trace_chunked(pc, o, d, compact=pc.num_chunks - 1)


def test_trace_chunked_picks_the_engine_by_row_width(soup):
    _, ps, _, pc = soup
    o, d = (t_(x) for x in rays(64, 3))
    assert pchunked.resolve_chunk_impl("auto", 64, "cpu") == "plain4"
    assert pchunked.resolve_chunk_impl("auto", 64, "cuda") == "cuda4"
    assert pchunked.resolve_chunk_impl("auto", 32, "cuda") == "cuda2"
    assert pchunked.resolve_chunk_impl("auto", 32, "cpu") == "plain2"
    with pytest.raises(ValueError, match="not a chunk record table"):
        pchunked.resolve_chunk_impl("auto", 52, "cuda")  # no chunked compressed tables
    with pytest.raises(ValueError, match="does not read"):
        pt.trace_chunked(pc, o, d, impl="plain2")
    with pytest.raises(ValueError, match="impl"):
        pt.trace_chunked(pc, o, d, impl="perray")


def test_occluded_chunked_vs_jax(soup):
    js, ps, jc, pc = soup
    o, d = rays(1024, 13, bound=6.0)
    want = np.asarray(rt.occluded_chunked(jc, o, d))
    got = n_(pt.occluded_chunked(pc, t_(o), t_(d)))
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < got.size
    # The any-hit boolean equals the nearest-hit one over the same chunks.
    one = pt.build_bvh(ps, builder="sah")
    np.testing.assert_array_equal(got, n_(pdispatch.occluded(ps, one, t_(o), t_(d))))


def _frame_inputs(m, width, height, **kw):
    cam = m.make_camera(eye=(12.0, 10.0, 15.0), target=(0.0, 0.0, 0.0), width=width,
                        height=height, **kw)
    return cam, m.solid_texture((0.8, 0.7, 0.6, 1.0), **kw)


_BG = np.asarray([0.1, 0.1, 0.12], np.float32)


def _covered(frame) -> float:
    """Share of pixels that are not the plain background."""
    rgb = n_(frame)[..., :3]
    return float((rgb != _BG).any(axis=-1).mean())


def test_render_frame_chunked_vs_jax_frame():
    """The whole chunked frame with shadows against the JAX package's, within
    the golden tolerance (32-divisible: tile-major rays)."""
    js, ps = _scenes("terrain16")
    jc = rt.build_bvh_chunked(js, chunk_capacity=128)
    pc = pt.build_bvh_chunked(ps, chunk_capacity=128)
    jcam, jtex = _frame_inputs(rt, 64, 64)
    pcam, ptex = _frame_inputs(pt, 64, 64, device=CPU)
    want = rt.render_frame_chunked(js, jc, jcam, jtex, _BG, shadows=True)
    got = pt.render_frame_chunked(ps, pc, pcam, ptex, _BG, shadows=True)
    assert tuple(got.shape) == (64, 64, 4)
    compare_images(frame_to_uint8(pt.frame_to_image(got)),
                   frame_to_uint8(rt.frame_to_image(want)), "chunked frame")
    assert 0.05 < _covered(got) < 0.95


def test_render_frame_chunked_row_major_equals_one_tree():
    """Dims that are not whole 32x32 tiles trace in row-major order; the
    chunked frame equals the single-tree frame of the same scene within the
    golden tolerance, shadows included."""
    _, ps = _scenes("terrain16")
    pc = pt.build_bvh_chunked(ps, chunk_capacity=128)
    cam, tex = _frame_inputs(pt, 70, 50, device=CPU)
    got = pt.render_frame_chunked(ps, pc, cam, tex, _BG, shadows=True)
    want = pt.render_frame(ps, pt.build_bvh(ps, builder="sah"), cam, tex, _BG, shadows=True)
    assert tuple(got.shape) == (50, 70, 4)
    compare_images(frame_to_uint8(pt.frame_to_image(got)),
                   frame_to_uint8(pt.frame_to_image(want)), "chunked frame, row-major")
    assert 0.05 < _covered(got) < 0.95


def test_render_frames_chunked_equals_per_frame():
    """A batch of frames folds every frame's rays over the chunks at once and
    equals per-frame calls bit for bit (packet-aligned frame sizes)."""
    mesh = pt.terrain_mesh(res=24, size=24.0, amplitude=5.0, seed=3)
    scene = pt.build_scene(mesh, device=CPU)
    cbvh = pt.build_bvh_chunked(scene, chunk_capacity=256)
    assert cbvh.num_chunks > 2
    tex = pt.solid_texture((0.8, 0.7, 0.6, 1.0), device=CPU)
    bg = np.asarray([0.1, 0.1, 0.12], np.float32)
    cams = [
        pt.make_camera(eye=(18 * np.cos(a), 14.0, 18 * np.sin(a)), target=(0, 0, 0),
                       width=64, height=64, device=CPU)
        for a in (0.3, 1.2, 2.4)
    ]
    got = pt.render_frames_chunked(scene, cbvh, pt.stack_cameras(cams), tex, bg,
                                   shadows=True)
    assert tuple(got.shape) == (3, 64, 64, 4)
    for i, cam in enumerate(cams):
        want = pt.render_frame_chunked(scene, cbvh, cam, tex, bg, shadows=True)
        assert torch.equal(got[i], want), i
    with pytest.raises(ValueError, match="32-divisible"):
        pt.render_frames_chunked(
            scene, cbvh, pt.stack_cameras([pt.make_camera(
                eye=(9, 9, 9), target=(0, 0, 0), width=40, height=32, device=CPU)]),
            tex, bg)


def test_chunk_capacity_contract_names_the_limit():
    """The port's chunk limit is the record ids its kernels decode, raised as
    CapacityError before any table is packed."""
    with pytest.raises(pdispatch.CapacityError, match="21-bit"):
        pchunked._check_chunk_records("bvh4", 1 << 21, 1 << 20, 1 << 22)
    with pytest.raises(pdispatch.CapacityError, match="21-bit"):
        pchunked._check_chunk_records("bvh4", 1000, 1 << 21, 1 << 21)
    with pytest.raises(pdispatch.CapacityError, match="20-bit"):
        pchunked._check_chunk_records("bvh2", 0, 1 << 20, 1 << 20)
    pchunked._check_chunk_records("bvh4", 150000, 163840, 163840)  # the default passes
    pchunked._check_chunk_records("bvh2", 0, 163840, 163840)
    _, ps = _scenes("terrain16")
    with pytest.raises(ValueError, match="builder"):
        pt.build_bvh_chunked(ps, builder="binned")
    with pytest.raises(ValueError, match="record_format"):
        pt.build_bvh_chunked(ps, record_format="bvh8")
