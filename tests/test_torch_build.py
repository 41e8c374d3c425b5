"""Karras build parity of the PyTorch port against the JAX package: every
array bit-identical, stage by stage and for the whole build."""
import numpy as np
import pytest
import torch

import unitysimpleraytracing_tpu as rt
import unitysimpleraytracing_tpu_torch as pt
from unitysimpleraytracing_tpu.ops import lbvh as jlbvh
from unitysimpleraytracing_tpu.ops import sort as jsort
from unitysimpleraytracing_tpu.ops import unique as junique
from unitysimpleraytracing_tpu_torch.io import convert
from unitysimpleraytracing_tpu_torch.ops import lbvh as plbvh
from unitysimpleraytracing_tpu_torch.ops import sort as psort
from unitysimpleraytracing_tpu_torch.ops import unique as punique
from unitysimpleraytracing_tpu_torch.utils import reference_impl

from _torch_common import (
    CPU, assert_fields_same_bits, assert_same_bits, both_built, both_scenes, n_,
)

_BUILD_SCENES = ["cube", "soup97", "soup300", "soup300_dups", "terrain20", "terrain48"]
_TOPO_NAMES = (
    "left", "right", "left_is_leaf", "right_is_leaf", "internal_parent",
    "leaf_parent", "range_first", "range_last", "split_axis",
)


def _sorted_unique(name):
    """Sorted + uniquified keys of both packages for one scene."""
    js, ps = both_scenes(name)
    jk, jv = jsort.sort_key_val(js.morton, js.tri_index, impl="lex2")
    pk, pv = psort.sort_key_val(ps.morton, ps.tri_index)
    ju = junique.distribute_keys(jk, js.count)
    pu = punique.distribute_keys(pk, ps.count)
    return js, ps, (jk, jv, ju), (pk, pv, pu)


@pytest.mark.parametrize("name", _BUILD_SCENES)
def test_sort_and_distribute_keys_bit_identical(name):
    js, ps, (jk, jv, ju), (pk, pv, pu) = _sorted_unique(name)
    assert_same_bits(pk, jk, "sorted keys")
    assert_same_bits(pv, jv, "sorted values")
    assert_same_bits(pu, ju, "distributed keys")
    # Stable: also equals the JAX stable pair sort.
    xk, xv = jsort.sort_key_val(js.morton, js.tri_index, impl="xla")
    assert_same_bits(pv, xv, "stable order")
    real = n_(pu)[: ps.count]
    assert np.all(np.diff(real) > 0), "keys not strictly increasing"


def test_duplicate_keys_are_forced():
    """The coarse-bound soup really has duplicate Morton keys (so the
    distribute_keys comparison above is not vacuous)."""
    _, ps = both_scenes("soup300_dups")
    keys = n_(ps.morton)[: ps.count]
    assert len(np.unique(keys)) < ps.count


def test_sort_is_stable_on_duplicate_keys_and_values():
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 16, size=2048).astype(np.uint32)
    vals = np.arange(2048, dtype=np.int32)
    jk, jv = jsort.sort_key_val(keys, vals, impl="xla")
    pk, pv = psort.sort_key_val(
        torch.from_numpy(keys.astype(np.int64)), torch.from_numpy(vals))
    assert_same_bits(pk, jk)
    assert_same_bits(pv, jv)


@pytest.mark.parametrize("with_parents", [True, False])
@pytest.mark.parametrize("name", _BUILD_SCENES)
def test_build_topology_bit_identical(name, with_parents):
    js, ps, (_, _, ju), (_, _, pu) = _sorted_unique(name)
    want = jlbvh.build_topology(ju, js.count, with_parents=with_parents)
    got = plbvh.build_topology(pu, ps.count, with_parents=with_parents)
    assert len(got) == len(want) == 9
    for nm, g, w in zip(_TOPO_NAMES, got, want):
        assert_same_bits(g, w, nm)


@pytest.mark.parametrize("name", ["cube", "soup97", "soup300_dups", "terrain20"])
def test_topology_matches_scalar_oracle(name):
    """The port's own topology against the scalar Karras transcription."""
    _, ps, _, (_, _, pu) = _sorted_unique(name)
    n = ps.count
    got = plbvh.build_topology(pu, n, with_parents=True)
    codes = n_(pu).astype(np.uint32)
    want = reference_impl.karras_topology(codes, n)
    left, right, lleaf, rleaf, ipar, lpar, first, last, _ = (n_(g) for g in got)
    for g, w, m in (
        (left, want[0], n - 1), (right, want[1], n - 1), (lleaf, want[2], n - 1),
        (rleaf, want[3], n - 1), (ipar, want[4], n - 1), (lpar, want[5], n),
        (first, want[6], n - 1), (last, want[7], n - 1),
    ):
        np.testing.assert_array_equal(g[:m], w)


@pytest.mark.parametrize("name", _BUILD_SCENES)
def test_compute_depths_and_refit_bit_identical(name):
    js, jb, ps, pb = both_built(name, diagnostics=True)
    assert_same_bits(
        plbvh.compute_depths(pb.internal_parent, pb.count),
        jlbvh.compute_depths(jb.internal_parent, jb.count), "depth",
    )
    jmin, jmax = jlbvh.refit(
        jb.range_first, jb.range_last, jb.sorted_tri, js.aabb_min, js.aabb_max, js.count)
    pmin, pmax = plbvh.refit(
        pb.range_first, pb.range_last, pb.sorted_tri, ps.aabb_min, ps.aabb_max, ps.count)
    assert_same_bits(pmin, jmin, "node_aabb_min")
    assert_same_bits(pmax, jmax, "node_aabb_max")


@pytest.mark.parametrize("diagnostics", [True, False])
@pytest.mark.parametrize("name", _BUILD_SCENES)
def test_build_bvh_every_field_bit_identical(name, diagnostics):
    _, jb, _, pb = both_built(name, diagnostics=diagnostics)
    assert pb.count == jb.count and pb.capacity == jb.capacity
    assert pb.num_internal == jb.num_internal
    assert_fields_same_bits(pb, jb)


@pytest.mark.parametrize("name", ["soup97", "terrain20"])
def test_attach_diagnostics_bit_identical(name):
    _, jb, _, pb = both_built(name, diagnostics=False)
    assert_fields_same_bits(plbvh.attach_diagnostics(pb), jlbvh.attach_diagnostics(jb))
    _, _, _, full = both_built(name, diagnostics=True)
    assert_fields_same_bits(plbvh.attach_diagnostics(pb), full)


@pytest.mark.parametrize("name", ["soup300", "terrain20"])
def test_refit_after_deform_bit_identical(name):
    js, jb, ps, pb = both_built(name)
    rng = np.random.default_rng(6)
    n, cap = ps.count, ps.capacity
    pos = np.zeros((cap, 3, 3), np.float32)
    tri = ps.triangles
    pos[:, 0], pos[:, 1], pos[:, 2] = n_(tri.a), n_(tri.b), n_(tri.c)
    pos[:n] += rng.normal(scale=0.3, size=(n, 3, 3)).astype(np.float32)
    js2 = rt.deform_scene(js, pos)
    ps2 = pt.deform_scene(ps, torch.from_numpy(pos))
    assert_fields_same_bits(ps2, js2)
    jb2 = rt.refit_bvh(js2, jb)
    pb2 = pt.refit_bvh(ps2, pb)
    assert_fields_same_bits(pb2, jb2)
    # Topology tensors keep their identity (the table cache keys on it).
    assert pb2.left is pb.left and pb2.sorted_tri is pb.sorted_tri
    assert not torch.equal(pb2.node_aabb_min, pb.node_aabb_min)


def test_bvh_carried_across_round_trips():
    js, jb, ps, pb = both_built("soup97", diagnostics=True)
    carried = convert.bvh_from_numpy(jb, device=CPU)
    assert_fields_same_bits(carried, jb)
    for f, v in convert.to_numpy(pb).items():
        assert_same_bits(v, getattr(jb, f), f) if isinstance(v, np.ndarray) else None
    scene_np = convert.to_numpy(ps)
    assert scene_np["morton"].dtype == np.uint32
    np.testing.assert_array_equal(scene_np["morton"], np.asarray(js.morton))
    back = convert.scene_from_numpy(scene_np, device=CPU)
    assert_fields_same_bits(back, js)


def test_validate_and_tiny_scenes_raise():
    _, ps = both_scenes("cube")
    # validate=True is ported: it returns the diagnostics build.
    assert_fields_same_bits(
        pt.build_bvh(ps, builder="karras", validate=True),
        pt.build_bvh(ps, builder="karras", diagnostics=True))
    one = pt.build_scene(
        pt.MeshData(
            positions=pt.cube_mesh().positions[:1],
            uvs=pt.cube_mesh().uvs[:1],
            normals=pt.cube_mesh().normals[:1],
        ),
        device=CPU,
    )
    with pytest.raises(ValueError):
        pt.build_bvh(one, builder="karras")
