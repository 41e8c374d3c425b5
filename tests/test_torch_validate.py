"""Validators of the PyTorch port against the JAX package's: they accept what
JAX's accept and reject the same corruptions, on sort passes and on trees
built by the port; ``build_bvh(validate=True)`` and ``build_bvh(sort_impl=...)``
on the CPU.  Tolerance: none — every comparison is exact."""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unitysimpleraytracing_tpu as rt
import unitysimpleraytracing_tpu_torch as pt
from unitysimpleraytracing_tpu.ops import sort as jsort
from unitysimpleraytracing_tpu.utils import validate as JV
from unitysimpleraytracing_tpu_torch.io import convert
from unitysimpleraytracing_tpu_torch.ops import sort as psort
from unitysimpleraytracing_tpu_torch.ops import sort_radix_cuda as pcu
from unitysimpleraytracing_tpu_torch.utils import validate as PV

from _torch_common import CPU, assert_fields_same_bits, both_built, both_scenes, n_, t_

_SCENES = ["cube", "soup97", "soup300_dups", "terrain20"]


def _random_kv(n, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    return keys, np.arange(n, dtype=np.int32)


@pytest.mark.parametrize("n", [4096, 7168])
@pytest.mark.parametrize("impl", ["radix", "cuda"])
def test_per_pass_validation_clean(impl, n):
    """Clean engines pass, from tensors and from numpy uint32 keys; 7168 is
    a capacity-padded size that is not a multiple of SORT_BLOCK."""
    keys, values = _random_kv(n, seed=7)
    PV.validate_sort_per_pass(t_(keys.astype(np.int64)), t_(values), impl=impl)
    PV.validate_sort_per_pass(keys, values, impl=impl, device=CPU)
    JV.validate_sort_per_pass(
        jnp.asarray(keys), jnp.asarray(values), impl={"cuda": "pallas"}.get(impl, impl))


def test_per_pass_validation_rejects_unknown_engine():
    keys, values = _random_kv(1024, seed=1)
    with pytest.raises(AssertionError):
        PV.validate_sort_per_pass(keys, values, impl="torch", device=CPU)


def _corrupt(kind, keys, values, ko, vo, hist_t, scanned):
    """One of the corruptions of tests/test_sort.py on a pass's observables."""
    ko, vo, hist_t, scanned = (np.array(n_(x)) for x in (ko, vo, hist_t, scanned))
    if kind == "scan":
        scanned[100] += 1
    elif kind == "key":
        ko[5] ^= 0xFF
    elif kind == "histogram":
        hist_t[0] += 1
    elif kind == "swapped_keys":
        ko[[3, 900]] = ko[[900, 3]]
    else:
        assert kind == "stability"
        d = (keys & np.uint32(255))[np.argsort(keys & np.uint32(255), kind="stable")]
        i = int(np.nonzero(d[1:] == d[:-1])[0][0])
        vo[[i, i + 1]] = vo[[i + 1, i]]
    return ko, vo, hist_t, scanned


@pytest.mark.parametrize("kind", ["scan", "key", "histogram", "swapped_keys", "stability"])
@pytest.mark.parametrize("engine", ["radix", "cuda"])
def test_per_pass_validation_catches_corruption(engine, kind):
    keys, values = _random_kv(2048, seed=3)
    pk, pv = t_(keys.astype(np.int64)), t_(values)
    if engine == "radix":
        obs, block = psort.radix_pass_debug(pk, pv, 0), 2048
    else:
        obs, block = pcu.cuda_pass_debug(pk, pv, 0), pcu.BLOCK
    PV.validate_sort_pass(pk, pv, *obs, 0, block)
    JV.validate_sort_pass(keys, values, *(n_(x) for x in obs), 0, block)
    bad = _corrupt(kind, keys, values, *obs)
    with pytest.raises(AssertionError) as port_err:
        PV.validate_sort_pass(pk, pv, *bad, 0, block)
    with pytest.raises(AssertionError) as jax_err:
        JV.validate_sort_pass(keys, values, *bad, 0, block)
    assert str(port_err.value) == str(jax_err.value)


def test_single_checks_name_the_same_fault():
    keys, values = _random_kv(2048, seed=3)
    ko, vo, hist_t, scanned = (
        n_(x) for x in psort.radix_pass_debug(t_(keys.astype(np.int64)), t_(values), 0))
    bad_keys = ko.copy()
    bad_keys[5] ^= 0xFF
    for V in (PV, JV):
        with pytest.raises(AssertionError, match="histogram diff"):
            V.check_digit_histogram(keys, bad_keys, 0)
        with pytest.raises(AssertionError, match="recurrence"):
            V.check_scan_recurrence(hist_t, scanned + (np.arange(scanned.size) == 9))
        with pytest.raises(AssertionError, match="order violated"):
            V.check_sorted(ko[::-1].copy(), 2048)
        with pytest.raises(AssertionError, match="permutation"):
            V.check_permutation(keys, bad_keys, 2048)
        with pytest.raises(AssertionError, match="strictly increasing"):
            V.check_unique_strictly_increasing(np.array([0, 1, 1, 2]), 4)


def _as_numpy_bvh(bvh):
    return SimpleNamespace(**convert.to_numpy(bvh))


@pytest.mark.parametrize("name", _SCENES)
def test_tree_checks_accept_a_port_built_bvh(name):
    _, _, ps, pb = both_built(name, diagnostics=True)
    PV.check_topology(pb)
    PV.check_depths(pb)
    PV.check_refit(pb, ps.aabb_min, ps.aabb_max)
    # The JAX validators (scalar loops) accept the same tree.
    nb = _as_numpy_bvh(pb)
    JV.check_topology(nb)
    JV.check_depths(nb)
    JV.check_refit(nb, n_(ps.aabb_min), n_(ps.aabb_max))


def _break(kind, bvh, scene):
    """A copy of ``bvh`` with one fault, and the check that must catch it."""
    n = bvh.count
    if kind == "leaf_parent":
        leaf = int(bvh.left[bvh.left_is_leaf.nonzero()[0, 0]])
        x = bvh.leaf_parent.clone()
        x[leaf] = (int(x[leaf]) + 1) % (n - 1)
        return bvh.replace(leaf_parent=x), "check_topology"
    if kind == "internal_parent":
        x = bvh.internal_parent.clone()
        x[n - 2] = (int(x[n - 2]) + 1) % (n - 1)
        return bvh.replace(internal_parent=x), "check_topology"
    if kind == "child_link":
        x = bvh.left.clone()
        x[1] = bvh.left[2] if bvh.left_is_leaf[1] == bvh.left_is_leaf[2] else bvh.right[2]
        return bvh.replace(left=x), "check_topology"
    if kind == "null_link":
        x = bvh.right.clone()
        x[0] = -1
        return bvh.replace(right=x), "check_topology"
    if kind == "box":
        x = bvh.node_aabb_max.clone()
        x[n // 2, 1] += 0.5
        return bvh.replace(node_aabb_max=x), "check_refit"
    assert kind == "depth"
    x = bvh.depth.clone()
    x[n - 2] += 1
    return bvh.replace(depth=x), "check_depths"


@pytest.mark.parametrize(
    "kind", ["leaf_parent", "internal_parent", "child_link", "null_link", "box", "depth"])
@pytest.mark.parametrize("name", ["soup97", "terrain20"])
def test_tree_checks_reject_a_broken_bvh_like_jax(name, kind):
    _, _, ps, pb = both_built(name, diagnostics=True)
    broken, check = _break(kind, pb, ps)
    args = (ps.aabb_min, ps.aabb_max) if check == "check_refit" else ()
    with pytest.raises(AssertionError) as port_err:
        getattr(PV, check)(broken, *args)
    with pytest.raises(AssertionError) as jax_err:
        getattr(JV, check)(_as_numpy_bvh(broken), *(n_(a) for a in args))
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("name", _SCENES)
def test_build_bvh_validate_on_cpu(name):
    js, ps = both_scenes(name)
    got = pt.build_bvh(ps, builder="karras", validate=True)
    assert_fields_same_bits(got, pt.build_bvh(ps, builder="karras", diagnostics=True))
    assert_fields_same_bits(got, rt.build_bvh(js, "xla", builder="karras", validate=True))


def test_build_bvh_validate_caps_the_kernel_engine_on_cpu(monkeypatch):
    """On the CPU the "cuda" per-pass validation sees at most 16,384 keys;
    the "radix" one sees the scene's whole capacity."""
    ps = pt.build_scene(pt.terrain_mesh(res=96, size=40.0, amplitude=6.0, seed=0), device=CPU)
    assert ps.count > 16384
    seen = []
    real = PV.validate_sort_per_pass
    monkeypatch.setattr(
        PV, "validate_sort_per_pass",
        lambda k, v, impl="radix", device=None: (seen.append((impl, k.shape[0])),
                                                  real(k, v, impl=impl, device=device)))
    pt.build_bvh(ps, builder="karras", validate=True)
    assert seen == [("radix", ps.capacity), ("cuda", 16384)]


def test_build_bvh_validate_raises_when_a_stage_is_wrong(monkeypatch):
    """A sort that orders the keys but swaps two values of equal keys still
    gives a tree; the plain build goes through, the validated build raises."""
    _, ps = both_scenes("soup300_dups")
    real = psort.sort_key_val

    def unstable(keys, values, impl="torch"):
        ko, vo = real(keys, values, impl=impl)
        i = int((ko[1:] == ko[:-1]).nonzero()[0, 0])
        vo = vo.clone()
        vo[[i, i + 1]] = vo[[i + 1, i]]
        return ko, vo

    monkeypatch.setattr(psort, "sort_key_val", unstable)
    pt.build_bvh(ps, builder="karras")
    with pytest.raises(AssertionError, match="values violate stability"):
        pt.build_bvh(ps, builder="karras", validate=True)


@pytest.mark.parametrize("impl", ["torch", "radix", "cuda"])
@pytest.mark.parametrize("name", _SCENES)
def test_build_bvh_sort_engines_bit_identical_to_jax(name, impl):
    js, ps = both_scenes(name)
    want = rt.build_bvh(js, builder="karras")
    assert_fields_same_bits(pt.build_bvh(ps, impl, builder="karras"), want)
    assert_fields_same_bits(pt.build_bvh(ps, sort_impl=impl, builder="karras"), want)


def test_build_bvh_rejects_unknown_sort_engine():
    _, ps = both_scenes("cube")
    with pytest.raises(ValueError, match="unknown sort impl"):
        pt.build_bvh(ps, sort_impl="lex2", builder="karras")
