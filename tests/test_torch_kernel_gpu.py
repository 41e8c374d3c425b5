"""The hand-written CUDA kernel against its plain PyTorch version, on the
card.  Imports nothing of JAX.  Run on a machine with an NVIDIA GPU:

    python -m pytest tests/test_torch_kernel_gpu.py -m gpu -n 0 --noconftest

Without a CUDA device every test here skips (``chip_smoke.py`` makes the same
comparison at full size and is the gate for the kernel)."""
import numpy as np
import pytest
import torch

import unitysimpleraytracing_tpu_torch as pt
from unitysimpleraytracing_tpu_torch.ops import dispatch, trace_bvh4
from unitysimpleraytracing_tpu_torch.utils.parity import assert_hit_parity

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpreter form")
    return torch.device("cuda")


def _np(h):
    from types import SimpleNamespace

    return SimpleNamespace(**{k: getattr(h, k).cpu().numpy() for k in ("t", "tri", "u", "v")})


def _rays(n, seed, bound, dev):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-bound, bound, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)


@pytest.mark.parametrize("scene_name", ["cube", "soup", "terrain"])
def test_kernel_bit_identical_to_plain(card, scene_name):
    mesh = {
        "cube": lambda: pt.cube_mesh(size=2.0),
        "soup": lambda: pt.random_triangle_soup(3000, seed=7, bound=5.0, tri_size=1.0),
        "terrain": lambda: pt.terrain_mesh(res=64, size=20.0, amplitude=4.0, seed=0),
    }[scene_name]()
    scene = pt.build_scene(mesh)
    bvh = pt.build_bvh(scene, builder="karras")
    table = trace_bvh4.prepare_tables4(scene, bvh)
    o, d = _rays(10000, seed=3, bound=8.0, dev=card)
    before = trace_bvh4.traverse_bvh4.launches
    got, steps = trace_bvh4.traverse_bvh4(table, o, d, count_steps=True)
    torch.cuda.synchronize()
    assert trace_bvh4.traverse_bvh4.launches == before + 1
    want, wsteps = trace_bvh4.traverse_bvh4_plain(table, o, d, count_steps=True)
    assert_hit_parity(_np(got), _np(want), exact=True)
    assert torch.equal(steps, wsteps)
    # any-hit and t_init through the same kernel
    thr = torch.full((10000,), 9.0, device=card)
    g = trace_bvh4.traverse_bvh4(table, o, d, anyhit_thresh=thr)
    w = trace_bvh4.traverse_bvh4_plain(table, o, d, anyhit_thresh=thr)
    assert torch.equal(g.t, w.t) and torch.equal(g.tri, w.tri)
    seed_t = torch.where(got.hit, got.t + 0.01, got.t)
    g = trace_bvh4.traverse_bvh4(table, o, d, t_init=seed_t)
    assert torch.equal(g.t[got.hit], got.t[got.hit])


def test_auto_dispatch_launches_the_kernel_on_cuda_rays(card):
    scene = pt.build_scene(pt.cube_mesh(size=2.0))
    bvh = pt.build_bvh(scene, builder="karras")
    o, d = _rays(1000, seed=1, bound=4.0, dev=card)  # ragged: padded to a warp
    before = trace_bvh4.traverse_bvh4.launches
    hits = dispatch.trace_rays(scene, bvh, o, d)
    assert trace_bvh4.traverse_bvh4.launches == before + 1
    ref = dispatch.trace_rays(scene, bvh, o, d, impl="perray")
    assert_hit_parity(_np(hits), _np(ref), exact=True)
    assert trace_bvh4.traverse_bvh4.launches == before + 1  # perray: no launch


def test_wrapper_raises_on_mixed_devices(card):
    scene = pt.build_scene(pt.cube_mesh(size=2.0))
    bvh = pt.build_bvh(scene, builder="karras")
    table = trace_bvh4.prepare_tables4(scene, bvh)
    o, d = _rays(64, seed=1, bound=4.0, dev=card)
    with pytest.raises(ValueError, match="is on"):
        trace_bvh4.traverse_bvh4(table.cpu(), o, d)
