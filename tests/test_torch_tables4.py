"""BVH4 record-table parity of the PyTorch port against the JAX package:
node mask, compacted ids, record count and the (cap4, 64) table, bit for bit."""
import gc

import numpy as np
import pytest
import torch

import unitysimpleraytracing_tpu as rt
import unitysimpleraytracing_tpu_torch as pt
from unitysimpleraytracing_tpu.ops import trace_pallas4 as jt4
from unitysimpleraytracing_tpu_torch.io import convert
from unitysimpleraytracing_tpu_torch.ops import trace_bvh4 as pt4

from _torch_common import CPU, assert_same_bits, both_built, n_

_SCENES = ["cube", "soup97", "soup300", "soup300_dups", "terrain20", "terrain48"]


@pytest.mark.parametrize("name", _SCENES)
def test_node_mask_bit_identical(name):
    _, jb, _, pb = both_built(name)
    jmask, jnew = jt4.bvh4_node_mask(jb)
    pmask, pnew = pt4.bvh4_node_mask(pb)
    assert_same_bits(pmask, jmask, "mask")
    assert_same_bits(pnew, jnew, "new_id")
    _, _, jcount = jt4._node_mask_cached(jb)
    _, _, pcount = pt4._node_mask_cached(pb)
    assert pcount == jcount == int(n_(pmask).sum())
    assert bool(pmask[0]) and int(pnew[0]) == 0  # root is BVH4 node 0


def test_node_mask_is_even_depth():
    _, _, _, pb = both_built("soup97", diagnostics=True)
    mask, _ = pt4.bvh4_node_mask(pb)
    depth = n_(pb.depth)[: pb.count - 1]
    np.testing.assert_array_equal(n_(mask)[: pb.count - 1], depth % 2 == 0)


@pytest.mark.parametrize("name", _SCENES)
def test_table_bit_identical(name):
    js, jb, ps, pb = both_built(name)
    want = jt4.prepare_tables4(js, jb, pack=1)
    got = pt4.prepare_tables4(ps, pb)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert pt4.table_geometry(got) == jt4.table_geometry(want)[0]
    assert_same_bits(got, want, "table")


def test_table_worst_case_count_bit_identical():
    """pack_tables4 without a record count uses the (2·cap)/3+2 bound."""
    js, jb, ps, pb = both_built("soup97")
    assert_same_bits(pt4.pack_tables4(ps, pb), jt4.pack_tables4(js, jb, pack=1), "table")


def test_cube_root_has_empty_entries():
    """n=12: some root entries are EMPTY — inverted box, leaf bit, zero verts."""
    _, _, ps, pb = both_built("cube")
    table = n_(pt4.prepare_tables4(ps, pb))
    metas = table[:, 24:28].astype(np.int64)
    boxes = table[:, :24].reshape(-1, 4, 6)
    empty = boxes[:, :, 0] > boxes[:, :, 3]
    assert empty.any()
    assert np.all(((metas >> 21) & 1)[empty] == 1)
    verts = table[:, 28:].reshape(-1, 4, 9)
    assert np.all(verts[empty] == 0)


def test_table_cull_widening_past_8192_bit_identical():
    """A scene scaled past 8192 extent takes the box-widening branch."""
    def make(m):
        mesh = m.random_triangle_soup(200, seed=5, bound=5.0, tri_size=1.0)
        mesh.positions *= np.float32(3000.0)
        return mesh

    js, ps = rt.build_scene(make(rt)), pt.build_scene(make(pt), device=CPU)
    jb = rt.build_bvh(js, builder="karras")
    pb = pt.build_bvh(ps, builder="karras")
    root = max(float(pb.node_aabb_min[0].abs().max()), float(pb.node_aabb_max[0].abs().max()))
    assert root > 8192.0
    got = pt4.prepare_tables4(ps, pb)
    assert_same_bits(got, jt4.prepare_tables4(js, jb, pack=1), "table")
    # Widened: a leaf entry's box is strictly larger than the triangle's box.
    tri0 = int(n_(got)[0, 24:28].astype(np.int64)[0] & ((1 << 21) - 1))
    assert float(got[0, 0]) <= float(ps.aabb_min[tri0, 0])


def test_table_from_carried_jax_bvh_equals_port_built():
    js, jb, ps, pb = both_built("soup300")
    cs = convert.scene_from_numpy(js, device=CPU)
    cb = convert.bvh_from_numpy(jb, device=CPU)
    got = pt4.prepare_tables4(cs, cb)
    assert torch.equal(got, pt4.prepare_tables4(ps, pb))
    assert_same_bits(got, jt4.prepare_tables4(js, jb, pack=1), "table")


def test_prepare_tables4_cache_and_refit_plan_reuse():
    """One pack per (scene, bvh); a refit keeps the topology tensors, so the
    repack reuses the cached node mask and plan and differs only in geometry."""
    js, jb, ps, pb = both_built("terrain20")
    t1 = pt4.prepare_tables4(ps, pb)
    assert pt4.prepare_tables4(ps, pb) is t1
    key = id(pb.left)
    assert key in pt4._TOPO_CACHE and len(pt4._TOPO_CACHE[key][4]) == 1

    rng = np.random.default_rng(2)
    pos = np.stack([n_(ps.triangles.a), n_(ps.triangles.b), n_(ps.triangles.c)], axis=1)
    pos[: ps.count] += rng.normal(scale=0.2, size=(ps.count, 3, 3)).astype(np.float32)
    ps2 = pt.deform_scene(ps, torch.from_numpy(pos))
    pb2 = pt.refit_bvh(ps2, pb)
    t2 = pt4.prepare_tables4(ps2, pb2)
    assert t2 is not t1 and not torch.equal(t2, t1)
    assert len(pt4._TOPO_CACHE[key][4]) == 1  # plan reused, not recomputed
    assert torch.equal(t2[:, 24:28], t1[:, 24:28])  # metas are topology only
    js2 = rt.deform_scene(js, pos)
    assert_same_bits(t2, jt4.prepare_tables4(js2, rt.refit_bvh(js2, jb), pack=1), "table")

    # Entries die with their Bvh / topology tensor.
    bkey = id(pb2)
    assert bkey in pt4._TABLE4_CACHE
    del pb2, t2
    gc.collect()
    assert bkey not in pt4._TABLE4_CACHE


def test_meta_packing_envelope_raises():
    _, _, ps, pb = both_built("cube")
    with pytest.raises(ValueError, match="2\\^21"):
        pt4.pack_tables4(ps, pb, cap4=1 << 21)
    with pytest.raises(ValueError):
        pt4.table_geometry(torch.zeros((4, 32)))
