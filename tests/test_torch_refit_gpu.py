"""The animated frame's two kernels (``csrc/refit_bvh4.cu``) against their
plain versions, on the card: the bottom-up refit against ``lbvh.refit`` and
the record write against `refit_bvh4.write_records_plain`, bit for bit
(signed zeros and padding rows included), and the animated frame against the
unfused plain sequence.  Imports nothing of JAX.  Run on a machine with an
NVIDIA GPU:

    python -m pytest tests/test_torch_refit_gpu.py -m gpu -n 0 --noconftest

Without a CUDA device every test here skips (the kernels have no CPU or
interpreter form; ``tests/test_torch_refit.py`` replays the refit's climb on
the CPU)."""
import numpy as np
import pytest
import torch

import unitysimpleraytracing_tpu_torch as pt
from unitysimpleraytracing_tpu_torch.core.types import Bvh
from unitysimpleraytracing_tpu_torch.ops import dispatch, lbvh, refit_bvh4, trace_bvh2, trace_bvh4

pytestmark = pytest.mark.gpu

MESHES = {
    "cube": lambda: pt.cube_mesh(size=2.0),
    "soup": lambda: pt.random_triangle_soup(3000, seed=7, bound=5.0, tri_size=1.0),
    "terrain": lambda: pt.terrain_mesh(res=64, size=20.0, amplitude=4.0, seed=0),
}
FIELDS = ("t", "tri", "u", "v")


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpreter form")
    return torch.device("cuda")


def _same_bits(got, want, what=""):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if got.dtype == torch.float32:
        got, want = got.contiguous().view(torch.int32), want.contiguous().view(torch.int32)
    assert torch.equal(got, want), what


def _plain_refit(bvh, amin, amax):
    return lbvh.refit(bvh.range_first, bvh.range_last, bvh.sorted_tri, amin, amax, bvh.count)


def _kernel_refit(bvh, amin, amax):
    before = refit_bvh4.refit_nodes.launches
    got = refit_bvh4.refit_nodes(bvh, amin, amax)
    torch.cuda.synchronize()
    assert refit_bvh4.refit_nodes.launches == before + 1
    return got


def _assert_refit_equals_plain(bvh, amin, amax):
    got = _kernel_refit(bvh, amin, amax)
    for g, w, what in zip(got, _plain_refit(bvh, amin, amax), ("min", "max")):
        _same_bits(g, w, what)
    return got


def _corners(scene, phase):
    t = scene.triangles
    base = torch.stack([t.a, t.b, t.c], dim=1)
    pos = base.clone()
    pos[..., 1] += 0.4 * torch.sin(base[..., 0] * 0.5 + phase)
    return pos


@pytest.mark.parametrize("builder", ["sah_free", "karras"])
@pytest.mark.parametrize("scene_name", sorted(MESHES))
def test_refit_kernel_bit_identical_to_plain(card, scene_name, builder):
    scene = pt.build_scene(MESHES[scene_name]())
    bvh = pt.build_bvh(scene, builder=builder)
    assert bvh.capacity > bvh.count  # padding rows, written 0.0
    # The build's own boxes, then three deformed frames on the same
    # arrival counters.
    got = _assert_refit_equals_plain(bvh, scene.aabb_min, scene.aabb_max)
    _same_bits(got[0], bvh.node_aabb_min)
    _same_bits(got[1], bvh.node_aabb_max)
    for phase in (0.3, 1.1, 1.9):
        s2 = pt.deform_scene(scene, _corners(scene, phase))
        _assert_refit_equals_plain(bvh, s2.aabb_min, s2.aabb_max)
        _same_bits(pt.refit_bvh(s2, bvh).node_aabb_min, _plain_refit(bvh, s2.aabb_min,
                                                                     s2.aabb_max)[0])


def _single_leaf_tree(scene):
    """The tree of one triangle: no internal node, every link -1."""
    cap = scene.capacity
    none = torch.full((cap,), -1, dtype=torch.int32, device=scene.aabb_min.device)
    no = torch.zeros((cap,), dtype=torch.bool, device=none.device)
    zeros = torch.zeros((cap, 3), dtype=torch.float32, device=none.device)
    return Bvh(left=none, right=none.clone(), left_is_leaf=no, right_is_leaf=no.clone(),
               internal_parent=none.clone(), leaf_parent=none.clone(), range_first=none.clone(),
               range_last=none.clone(), split_axis=torch.zeros_like(none), node_aabb_min=zeros,
               node_aabb_max=zeros.clone(), sorted_tri=torch.arange(cap, dtype=torch.int32,
                                                                    device=none.device),
               depth=none.clone(), count=1)


@pytest.mark.parametrize("builder", ["sah_free", "karras"])
@pytest.mark.parametrize("count", [1, 2, 3])
def test_refit_kernel_at_one_two_and_three_triangles(card, count, builder):
    scene = pt.build_scene(pt.random_triangle_soup(count, seed=count, bound=3.0))
    bvh = _single_leaf_tree(scene) if count == 1 else pt.build_bvh(scene, builder=builder)
    for _ in range(3):
        got = _assert_refit_equals_plain(bvh, scene.aabb_min, scene.aabb_max)
    assert bool((got[0][count - 1:] == 0).all()) and bool((got[1][count - 1:] == 0).all())


@pytest.mark.parametrize("builder", ["sah_free", "karras"])
def test_refit_kernel_keeps_the_sign_of_zero(card, builder):
    """Boxes that touch +0.0 and -0.0: most coordinates are zeros of either
    sign, so node boxes are ties of the two, broken as the plain version
    breaks them."""
    scene = pt.build_scene(MESHES["soup"]())
    bvh = pt.build_bvh(scene, builder=builder)
    rng = np.random.default_rng(11)
    vals = np.array([-0.0, 0.0, -1.0, 1.0], np.float32)

    def boxes():
        return torch.from_numpy(rng.choice(vals, size=(bvh.capacity, 3),
                                           p=[0.45, 0.45, 0.05, 0.05])).to(card)

    for _ in range(3):
        amin, amax = boxes(), boxes()
        got = _assert_refit_equals_plain(bvh, amin, amax)
        bits = torch.cat(got).view(torch.int32)[: bvh.count - 1]
        assert bool((bits == 0).any()) and bool((bits == -(2**31)).any())


def test_refit_kernel_on_two_streams_and_its_checks(card):
    scene = pt.build_scene(MESHES["terrain"]())
    bvh = pt.build_bvh(scene)
    s2 = pt.deform_scene(scene, _corners(scene, 0.7))
    want = _plain_refit(bvh, s2.aabb_min, s2.aabb_max)
    side = torch.cuda.Stream()
    for _ in range(2):
        with torch.cuda.stream(side):
            got_side = refit_bvh4.refit_nodes(bvh, s2.aabb_min, s2.aabb_max)
        got = refit_bvh4.refit_nodes(bvh, s2.aabb_min, s2.aabb_max)
        torch.cuda.synchronize()
        for g, s, w in zip(got, got_side, want):
            _same_bits(g, w)
            _same_bits(s, w)
    with pytest.raises(TypeError, match="float32"):
        refit_bvh4.refit_nodes(bvh, s2.aabb_min.double(), s2.aabb_max)
    with pytest.raises(ValueError, match="shape"):
        refit_bvh4.refit_nodes(bvh, s2.aabb_min[:-1], s2.aabb_max)
    mask, new_id, cap4 = trace_bvh4._node_mask_cached(bvh)
    plan = trace_bvh4._pack_plan4(bvh, mask, new_id, cap4)
    with pytest.raises(ValueError, match="cpu"):
        refit_bvh4.write_records(s2, bvh.replace(node_aabb_min=bvh.node_aabb_min.cpu()), *plan)
    with pytest.raises(TypeError, match="int64"):
        refit_bvh4.write_records(s2, bvh, plan[0].to(torch.int32), plan[1])


def _wide_terrain():
    """A terrain 40,000 units across: the root box passes 8,192, so the
    records' cull margin is not zero."""
    return pt.terrain_mesh(res=64, size=40000.0, amplitude=800.0, seed=2)


@pytest.mark.parametrize("scene_name", sorted(MESHES) + ["wide"])
def test_record_kernel_bit_identical_to_plain(card, scene_name):
    scene = pt.build_scene(_wide_terrain() if scene_name == "wide" else MESHES[scene_name]())
    bvh = pt.build_bvh(scene)
    root = torch.maximum(bvh.node_aabb_min[0].abs().max(), bvh.node_aabb_max[0].abs().max())
    assert (float(root) > 8192.0) == (scene_name == "wide")
    mask, new_id, cap4 = trace_bvh4._node_mask_cached(bvh)
    s2 = pt.deform_scene(scene, _corners(scene, 0.5))
    b2 = pt.refit_bvh(s2, bvh)
    # The actual record count, and pack_tables4's worst-case bound (its
    # padding rows repeat node 0's entries).
    for rows in (max(cap4, 1), (2 * bvh.capacity) // 3 + 2):
        plan = trace_bvh4._pack_plan4(bvh, mask, new_id, rows)
        for sc, tree in ((scene, bvh), (s2, b2)):
            before = refit_bvh4.write_records.launches
            got = trace_bvh4._apply_plan4(sc, tree, *plan)
            torch.cuda.synchronize()
            assert refit_bvh4.write_records.launches == before + 1
            _same_bits(got, refit_bvh4.write_records_plain(sc, tree, *plan))
            assert tuple(got.shape) == (rows, 64)
    # A new tree's table goes through the kernel too.
    before = refit_bvh4.write_records.launches
    table = trace_bvh4.prepare_tables4(scene, bvh)
    assert refit_bvh4.write_records.launches == before + 1
    plan = trace_bvh4._pack_plan4(bvh, mask, new_id, max(cap4, 1))
    _same_bits(table, refit_bvh4.write_records_plain(scene, bvh, *plan))


@pytest.mark.parametrize("impl", ["cuda4", "cuda2"])
def test_animated_bit_identical_to_unfused(card, impl):
    """Ten frames of the animated renderer on the default tree against the
    unfused plain sequence (`deform_scene`, ``lbvh.refit``, the plain record
    write or the binary records, the traversal kernel): t, tri, u and v, and
    the refitted boxes and the record table word for word; each kernel's
    counter rises by one a frame."""
    scene = pt.build_scene(pt.terrain_mesh(res=32, size=16.0, amplitude=3.0, seed=1))
    bvh = pt.build_bvh(scene)
    cam = pt.make_camera(eye=(12, 10, 14), target=(0, 0, 0), width=64, height=64)
    anim = pt.make_animated_renderer(scene, bvh, cam, impl=impl)
    mask, new_id, cap4 = trace_bvh4._node_mask_cached(bvh)
    plan = trace_bvh4._pack_plan4(bvh, mask, new_id, max(cap4, 1))
    wrapper = trace_bvh4.traverse_bvh4 if impl == "cuda4" else trace_bvh2.traverse_bvh2
    counters = (refit_bvh4.refit_nodes, refit_bvh4.write_records, wrapper)
    for i in range(10):
        pos = _corners(scene, 0.3 + 0.4 * i)
        before = [c.launches for c in counters]
        got = anim(pos)
        torch.cuda.synchronize()
        rose = [c.launches - b for c, b in zip(counters, before)]
        assert rose == [1, 1 if impl == "cuda4" else 0, 1], rose
        s2 = pt.deform_scene(scene, pos)
        nmin, nmax = _plain_refit(bvh, s2.aabb_min, s2.aabb_max)
        b2 = bvh.replace(node_aabb_min=nmin, node_aabb_max=nmax)
        if impl == "cuda4":
            tables = refit_bvh4.write_records_plain(s2, b2, *plan)
        else:
            tables = trace_bvh2.pack_tables(s2, b2)
        ref = dispatch.camera_trace(s2, b2, cam, impl=impl, tables=tables)
        for f in FIELDS:
            _same_bits(getattr(got, f), getattr(ref, f), f)
        assert bool(got.hit.any())
        k2 = pt.refit_bvh(s2, bvh)
        _same_bits(k2.node_aabb_min, nmin)
        _same_bits(k2.node_aabb_max, nmax)
        if impl == "cuda4":
            _same_bits(trace_bvh4._apply_plan4(s2, k2, *plan), tables)
