"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Every test makes its inputs with numpy from a seed and hands the same arrays
to the JAX package and to the port (``device="cpu"``); results are compared
as numpy arrays.  One torch thread per worker: the suite runs under xdist.
"""
import dataclasses

import numpy as np
import torch

import unitysimpleraytracing_tpu as rt
import unitysimpleraytracing_tpu_torch as pt
from unitysimpleraytracing_tpu_torch.utils import parity

torch.set_num_threads(1)

CPU = "cpu"

# name -> (mesh factory of either package, build_scene kwargs)
SCENES = {
    "cube": (lambda m: m.cube_mesh(size=2.0), {}),
    "soup97": (lambda m: m.random_triangle_soup(97, seed=1, bound=5.0), {}),
    "soup300": (
        lambda m: m.random_triangle_soup(300, seed=7, bound=5.0, tri_size=1.0), {}
    ),
    # A coarse fixed bound collapses many centroids into one Morton cell:
    # forces duplicate keys through distribute_keys.
    "soup300_dups": (
        lambda m: m.random_triangle_soup(300, seed=7, bound=5.0, tri_size=1.0),
        {"scene_bound": 2000.0},
    ),
    "terrain20": (
        lambda m: m.terrain_mesh(res=20, size=20.0, amplitude=4.0, seed=0), {}
    ),
    "terrain48": (
        lambda m: m.terrain_mesh(res=48, size=40.0, amplitude=6.0, seed=0), {}
    ),
}


def both_scenes(name):
    """(JAX scene, port scene) of one named test scene."""
    make, kw = SCENES[name]
    return rt.build_scene(make(rt), **kw), pt.build_scene(make(pt), device=CPU, **kw)


def both_built(name, diagnostics=False):
    """(jax scene, jax karras bvh, port scene, port karras bvh)."""
    js, ps = both_scenes(name)
    jb = rt.build_bvh(js, builder="karras", diagnostics=diagnostics)
    pb = pt.build_bvh(ps, builder="karras", diagnostics=diagnostics)
    return js, jb, ps, pb


def rays(n, seed, bound=8.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-bound, bound, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def t_(x):
    """numpy → CPU tensor."""
    return torch.from_numpy(np.ascontiguousarray(x))


def n_(x):
    """tensor or JAX array → numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_same_bits(got, want, name="array"):
    """Port tensor against JAX array, bit for bit.  The port's int64 Morton
    convention is narrowed to the JAX dtype first (values must fit)."""
    got, want = n_(got), n_(want)
    if got.dtype != want.dtype and got.dtype.kind in "iu" and want.dtype.kind in "iu":
        assert got.min() >= np.iinfo(want.dtype).min, name
        assert got.max() <= np.iinfo(want.dtype).max, name
        got = got.astype(want.dtype)
    parity.assert_bits_equal(got, want, name)


def assert_fields_same_bits(got_obj, want_obj, skip=()):
    for f in dataclasses.fields(got_obj):
        if f.name in skip:
            continue
        g, w = getattr(got_obj, f.name), getattr(want_obj, f.name)
        if isinstance(g, torch.Tensor):
            assert_same_bits(g, w, f.name)
        elif dataclasses.is_dataclass(g):
            assert_fields_same_bits(g, w)
        else:
            assert g == w, f.name
