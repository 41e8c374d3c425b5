"""The animated frame's geometry update on the CPU: the parent links the
refit kernel climbs are made once per topology, the wrappers of
``ops/refit_bvh4.py`` take their plain versions on CPU tensors and launch
nothing, and the kernel's climb, replayed in numpy in shuffled orders of
arrival with its arrival counters kept between calls, gives ``lbvh.refit``'s
boxes bit for bit.  Imports nothing of JAX.  The kernels themselves run in
``tests/test_torch_refit_gpu.py`` on the card."""
import inspect
import os

import numpy as np
import pytest
import torch

import unitysimpleraytracing_tpu_torch as pt
from unitysimpleraytracing_tpu_torch.ops import lbvh, refit_bvh4, trace_bvh4
from unitysimpleraytracing_tpu_torch.utils import kernel_build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"

MESHES = {
    "cube": lambda: pt.cube_mesh(size=2.0),
    "soup": lambda: pt.random_triangle_soup(300, seed=7, bound=5.0, tri_size=1.0),
    "terrain": lambda: pt.terrain_mesh(res=12, size=10.0, amplitude=2.0, seed=3),
    "two": lambda: pt.random_triangle_soup(2, seed=2, bound=3.0),
    "three": lambda: pt.random_triangle_soup(3, seed=3, bound=3.0),
}


def _corners(scene, phase):
    t = scene.triangles
    pos = torch.stack([t.a, t.b, t.c], dim=1).clone()
    pos[..., 1] += 0.3 * torch.sin(pos[..., 0] * 0.5 + phase)
    return pos


def _counting_parent_links(monkeypatch):
    calls = []
    real = lbvh.parent_links

    def counting(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(lbvh, "parent_links", counting)
    return calls


@pytest.mark.parametrize("impl", ["plain4", "plain2", "cuda4", "cuda2"])
def test_parent_links_are_made_once_per_topology(monkeypatch, impl):
    calls = _counting_parent_links(monkeypatch)
    scene = pt.build_scene(MESHES["terrain"](), device=CPU)
    bvh = pt.build_bvh(scene)
    cam = pt.make_camera((8.0, 6.0, 9.0), (0.0, 0.0, 0.0), 32, 32, device=CPU)
    anim = pt.make_animated_renderer(scene, bvh, cam, impl=impl)
    assert len(calls) == 1
    for i in range(5):
        assert bool(anim(_corners(scene, 0.2 * i)).hit.any())
    assert len(calls) == 1
    # A refitted tree keeps bvh.left, so it finds the links of its source
    # tree, and the BVH4 mask reads the same ones.
    b2 = pt.refit_bvh(pt.deform_scene(scene, _corners(scene, 0.9)), bvh)
    assert b2.left is bvh.left
    got, want = lbvh.topology_links(b2), lbvh.topology_links(bvh)
    assert got[0] is want[0] and got[1] is want[1]
    trace_bvh4.bvh4_node_mask(b2)
    assert len(calls) == 1
    # A new topology makes its own.
    lbvh.topology_links(pt.build_bvh(scene, builder="karras"))
    assert len(calls) == 2


def test_topology_links_equal_a_diagnostic_build():
    scene = pt.build_scene(MESHES["soup"](), device=CPU)
    bvh = pt.build_bvh(scene, builder="karras", diagnostics=True)
    internal_parent, leaf_parent = lbvh.topology_links(bvh)
    assert torch.equal(internal_parent, bvh.internal_parent)
    assert torch.equal(leaf_parent, bvh.leaf_parent)


@pytest.mark.parametrize("scene_name", ["soup", "terrain"])
def test_wrappers_on_cpu_take_plain_versions_and_count_no_launch(scene_name):
    scene = pt.build_scene(MESHES[scene_name](), device=CPU)
    bvh = pt.build_bvh(scene)
    s2 = pt.deform_scene(scene, _corners(scene, 0.4))
    got = refit_bvh4.refit_nodes(bvh, s2.aabb_min, s2.aabb_max)
    want = lbvh.refit(bvh.range_first, bvh.range_last, bvh.sorted_tri, s2.aabb_min,
                      s2.aabb_max, bvh.count)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    b2 = pt.refit_bvh(s2, bvh)
    assert torch.equal(b2.node_aabb_min, want[0]) and torch.equal(b2.node_aabb_max, want[1])
    mask, new_id, cap4 = trace_bvh4._node_mask_cached(bvh)
    plan = trace_bvh4._pack_plan4(bvh, mask, new_id, cap4)
    table = trace_bvh4._apply_plan4(s2, b2, *plan)
    assert torch.equal(table, refit_bvh4.write_records_plain(s2, b2, *plan))
    assert tuple(table.shape) == (cap4, refit_bvh4.SLOTS)
    assert refit_bvh4.refit_nodes.launches == 0 and refit_bvh4.write_records.launches == 0


def test_wrappers_on_a_cuda_tensor_have_no_path_to_the_plain_versions():
    """Each wrapper names its plain version once, under the test that the
    tensors lie on the CPU; past it the kernel is launched or the call
    raises, with no ``try`` that could swallow a failed build or launch."""
    def body_of(fn):
        src = inspect.getsource(fn)
        return src[src.index('"""', src.index('"""') + 3) + 3:]  # past the docstring

    for wrapper, plain, tensor in ((refit_bvh4.refit_nodes, "lbvh.refit(", "tri_aabb_min"),
                                   (refit_bvh4.write_records, "write_records_plain(",
                                    "scene.aabb_min")):
        body = body_of(wrapper)
        assert body.count(plain) == 1, wrapper.__name__
        cpu_branch = body.index(f'if {tensor}.device.type == "cpu":')
        assert cpu_branch < body.index(plain) < body.index("_launch(")
        assert body.index("_launch(") < body.index(".launches += 1")
        assert 'if dev.type != "cuda":' in body
        for banned in ("try:", "except", "compile", "torch.jit", "torch.cat", "maximum"):
            assert banned not in body, banned
    launcher = body_of(refit_bvh4._launch)
    assert "raise RuntimeError" in launcher and "_plain" not in launcher
    # The frame's callers reach the kernels through the wrappers.
    from unitysimpleraytracing_tpu_torch.pipeline import build

    assert "refit_bvh4.refit_nodes(" in inspect.getsource(build.refit_bvh)
    assert "refit_bvh4.write_records(" in inspect.getsource(trace_bvh4._apply_plan4)


def test_kernel_source_is_listed_for_the_build():
    text = open(os.path.join(kernel_build.CSRC_DIR, refit_bvh4.KERNEL_NAME + ".cu"),
                encoding="utf-8").read()
    head = text[:text.index("#include")]
    assert "Replaces no TPU kernel" in head and "What bounds them" in head
    for needed in ('extern "C" int refit_launch', 'extern "C" int records_launch',
                   "__global__", "cudaGetLastError", "atomicAdd(arrivals", "__threadfence()",
                   "__ldcg", "fmaxf(lo[k], slo[k])", "fmaxf(slo[k], lo[k])"):
        assert needed in text, needed
    for banned in ("#if", "cub::", "thrust::", "#include <torch", "#include <ATen"):
        assert banned not in text, banned
    assert os.path.dirname(kernel_build.library_path(refit_bvh4.KERNEL_NAME)) \
        == os.path.join(ROOT, "build")
    smoke = open(os.path.join(ROOT, "chip_smoke.py"), encoding="utf-8").read()
    names = smoke[smoke.index("kernel_names = ("):smoke.index("started = {")]
    assert "refit_bvh4.KERNEL_NAME" in names


# ---- the kernel's climb, replayed in numpy ---------------------------------------------

def _climb(bvh, amin, amax, order, arrivals):
    """``refit_kernel`` of csrc/refit_bvh4.cu, one thread after another in
    ``order``: each leaf climbs until it is the first arrival at a node.
    ``arrivals`` (int64 numpy, one per node) carries over between calls."""
    f32 = np.float32
    left, right = bvh.left.numpy(), bvh.right.numpy()
    lil, ril = bvh.left_is_leaf.numpy(), bvh.right_is_leaf.numpy()
    ip, lp = (x.numpy() for x in lbvh.topology_links(bvh))
    st = bvh.sorted_tri.numpy()
    amin, amax = amin.numpy(), amax.numpy()
    cap, n = bvh.capacity, bvh.count
    nmin = np.full((cap, 3), np.nan, f32)
    nmax = np.full((cap, 3), np.nan, f32)
    nmin[max(n - 1, 0):] = f32(0.0)
    nmax[max(n - 1, 0):] = f32(0.0)
    for p in order:
        lo, hi = -amin[st[p]], amax[st[p]].copy()
        child, child_is_leaf, node = p, True, lp[p]
        while node >= 0:
            arrivals[node] += 1
            if arrivals[node] % 2 == 1:  # the count it read was even: first arrival
                break
            from_left = left[node] == child and bool(lil[node]) == child_is_leaf
            sib, sib_is_leaf = (right[node], ril[node]) if from_left else (left[node], lil[node])
            if sib_is_leaf:
                slo, shi = -amin[st[sib]], amax[st[sib]]
            else:
                slo, shi = -nmin[sib], nmax[sib]
            lo = np.fmax(lo, slo) if from_left else np.fmax(slo, lo)
            hi = np.fmax(hi, shi) if from_left else np.fmax(shi, hi)
            nmin[node], nmax[node] = -lo, hi
            child, child_is_leaf, node = node, False, ip[node]
    return torch.from_numpy(nmin), torch.from_numpy(nmax)


@pytest.mark.parametrize("builder", ["sah_free", "karras"])
@pytest.mark.parametrize("scene_name", sorted(MESHES))
def test_the_climb_equals_the_range_query_refit(scene_name, builder):
    scene = pt.build_scene(MESHES[scene_name](), device=CPU)
    bvh = pt.build_bvh(scene, builder=builder)
    assert bvh.capacity > bvh.count  # padding rows
    arrivals = np.zeros(bvh.capacity, np.int64)
    rng = np.random.default_rng(5)
    for phase in (0.0, 0.6, 1.2):
        s2 = pt.deform_scene(scene, _corners(scene, phase))
        want = lbvh.refit(bvh.range_first, bvh.range_last, bvh.sorted_tri, s2.aabb_min,
                          s2.aabb_max, bvh.count)
        got = _climb(bvh, s2.aabb_min, s2.aabb_max, rng.permutation(bvh.count), arrivals)
        for g, w in zip(got, want):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))
        # Two arrivals at every internal node a call: the counters are even
        # between calls, so they need no reset.
        assert (arrivals[: bvh.count - 1] % 2 == 0).all() and (arrivals[bvh.count - 1:] == 0).all()
