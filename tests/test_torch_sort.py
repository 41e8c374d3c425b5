"""Sort engines of the PyTorch port against the JAX package: every per-pass
observable and every sort result bit-identical on the same numpy inputs.

The JAX "pallas" engine runs in interpret mode on the CPU; the port's "cuda"
engine runs its wrappers' plain versions on CPU tensors (the kernels
themselves are held against those on the card, tests/test_torch_kernel_gpu.py
and chip_smoke.py).  Tolerance: none — integers, exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unitysimpleraytracing_tpu import constants as JC
from unitysimpleraytracing_tpu.ops import sort as jsort
from unitysimpleraytracing_tpu.ops import sort_pallas as jsp
from unitysimpleraytracing_tpu_torch import constants as C
from unitysimpleraytracing_tpu_torch.ops import scan as pscan
from unitysimpleraytracing_tpu_torch.ops import sort as psort
from unitysimpleraytracing_tpu_torch.ops import sort_radix_cuda as pcu

from _torch_common import assert_same_bits, n_, t_

ENGINES = ["torch", "radix", "cuda"]
SHIFTS = [0, 8, 16, 24]


def _kv(kind, n, seed):
    """uint32 keys + iota values of one named distribution."""
    rng = np.random.default_rng(seed)
    if kind == "ragged":
        n += 37
    if kind == "duplicates":
        keys = rng.choice([0, 1, 5, 1 << 29, (1 << 30) - 1], size=n).astype(np.uint32)
    else:
        keys = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    if kind == "padding":
        keys[n - n // 3:] = JC.KEY_PADDING
        keys[: n - n // 3] >>= 2
    return keys, np.arange(n, dtype=np.int32)


def _port(keys, values):
    return t_(keys.astype(np.int64)), t_(values)


def test_constants_agree():
    for name in ("RADIX_BITS", "NUM_BUCKETS", "KEY_BITS", "NUM_PASSES", "SORT_BLOCK",
                 "KEY_PADDING"):
        assert getattr(C, name) == getattr(JC, name), name
    assert pcu.BLOCK == jsp.BLOCK == 1024


@pytest.mark.parametrize("shift", SHIFTS)
def test_radix_pass_observables_bit_identical(shift):
    keys, values = _kv("random", 8192, seed=shift)
    want = jsort.radix_pass_debug(jnp.asarray(keys), jnp.asarray(values), shift)
    got = psort.radix_pass_debug(*_port(keys, values), shift)
    for name, g, w in zip(("keys_out", "values_out", "hist_t", "scanned"), got, want):
        assert_same_bits(g, w, name)
    want_dst, _, _ = jsort._rank_pass(jnp.asarray(keys), shift, JC.SORT_BLOCK)
    got_dst, _, _ = psort._rank_pass(_port(keys, values)[0], shift, C.SORT_BLOCK)
    assert_same_bits(got_dst, want_dst, "dst")


@pytest.mark.parametrize("shift", SHIFTS)
def test_cuda_pass_observables_bit_identical(shift):
    keys, values = _kv("random", 4096, seed=10 + shift)
    nblocks = 4
    want = jsp.pallas_pass_debug(jnp.asarray(keys), jnp.asarray(values), shift)
    pk, pv = _port(keys, values)
    got = pcu.cuda_pass_debug(pk, pv, shift)
    for name, g, w in zip(("keys_out", "values_out", "hist_t", "scanned"), got, want):
        assert_same_bits(g, w, name)
    # dst: the JAX rank kernel on the JAX scan against the port's wrapper.
    _, rank_call = jsp._pass_fns(nblocks, shift, True)
    bases = jnp.asarray(want[3], jnp.float32).reshape(jsp._NB, nblocks).T
    want_dst = rank_call(
        jnp.asarray(keys).reshape(nblocks, 8, 128), bases.reshape(nblocks, 1, jsp._NB)
    ).reshape(-1)
    got_dst = pcu.digit_rank(pk, got[3], shift)
    assert_same_bits(got_dst, want_dst, "dst")
    assert_same_bits(pcu._sort_pass(pk, pv, shift)[4], want_dst, "dst of the pass")


@pytest.mark.parametrize("kind", ["random", "duplicates", "padding", "ragged"])
@pytest.mark.parametrize("n", [128, 1024, 8192])
@pytest.mark.parametrize("impl", ENGINES)
def test_sort_matches_stable_oracle_and_jax(impl, n, kind):
    keys, values = _kv(kind, n, seed=n)
    ko, vo = psort.sort_key_val(*_port(keys, values), impl=impl)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(n_(ko), keys[order].astype(np.int64))
    np.testing.assert_array_equal(n_(vo), values[order])
    assert ko.dtype == torch.int64 and vo.dtype == torch.int32
    jk, jv = jsort.sort_key_val(jnp.asarray(keys), jnp.asarray(values), impl="xla")
    assert_same_bits(ko, jk, "keys")
    assert_same_bits(vo, jv, "values")
    if kind == "padding":
        real = n - n // 3
        assert np.all(n_(ko)[real:] == C.KEY_PADDING) and np.all(n_(ko)[:real] < C.KEY_PADDING)


@pytest.mark.parametrize("impl", ENGINES)
def test_sort_is_stable_for_duplicate_values_too(impl):
    # Equal keys carrying equal and descending values: the engines that drop
    # the stable flag in the JAX package need distinct values; these do not.
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 16, size=2048).astype(np.uint32)
    values = (np.arange(2048, dtype=np.int32)[::-1] // 7).copy()
    ko, vo = psort.sort_key_val(*_port(keys, values), impl=impl)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(n_(vo), values[order])
    jk, jv = jsort.sort_key_val(jnp.asarray(keys), jnp.asarray(values), impl="xla")
    assert_same_bits(vo, jv, "values")


@pytest.mark.parametrize("impl", ENGINES)
def test_argsort_by_key(impl):
    keys, _ = _kv("random", 2048, seed=5)
    perm = psort.argsort_by_key(t_(keys.astype(np.int64)), impl=impl)
    assert perm.dtype == torch.int32
    np.testing.assert_array_equal(n_(perm), np.argsort(keys, kind="stable"))
    assert_same_bits(perm, jsort.argsort_by_key(jnp.asarray(keys)), "perm")


def test_radix_sort_single_block_and_multi_block_agree():
    pk, pv = _port(*_kv("random", 8192, seed=11))
    k1, v1 = psort.radix_sort_key_val(pk, pv, block=8192)
    k2, v2 = psort.radix_sort_key_val(pk, pv, block=1024)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)


@pytest.mark.parametrize("kind", ["random", "duplicates", "padding"])
def test_histogram_and_rank_wrappers_on_cpu(kind):
    """Layout and contents of the two kernels' outputs through their CPU
    path, against a numpy recount; no launch is counted."""
    keys, _ = _kv(kind, 4096, seed=2)
    pk = t_(keys.astype(np.int64))
    for shift in SHIFTS:
        d = ((keys >> np.uint32(shift)) & np.uint32(255)).astype(np.int64).reshape(4, 1024)
        hist = np.stack([np.bincount(row, minlength=256) for row in d])
        hist_t = pcu.digit_histogram(pk, shift)
        assert hist_t.dtype == torch.int32
        np.testing.assert_array_equal(n_(hist_t), hist.T.reshape(-1))
        bases = pscan.exclusive_scan(hist_t)
        dst = n_(pcu.digit_rank(pk, bases, shift))
        # dst realises the stable sort by this digit.
        out = np.empty_like(keys)
        out[dst] = keys
        np.testing.assert_array_equal(out, keys[np.argsort(d.reshape(-1), kind="stable")])
        assert torch.equal(hist_t, pcu.digit_histogram_plain(pk, shift))
    assert pcu.digit_histogram.launches == 0 and pcu.digit_rank.launches == 0


@pytest.mark.parametrize("call, exc", [
    (lambda k, v: psort.sort_key_val(k, v, impl="xla"), ValueError),
    (lambda k, v: psort.sort_key_val(k.int(), v, impl="radix"), TypeError),
    (lambda k, v: psort.sort_key_val(k.int(), v, impl="cuda"), TypeError),
    (lambda k, v: psort.sort_key_val(k, v[:-1], impl="cuda"), ValueError),
    (lambda k, v: psort.radix_pass_debug(k[:5000], v[:5000], 0), ValueError),
    (lambda k, v: pcu.cuda_pass_debug(k[:5000], v[:5000], 0), ValueError),
    (lambda k, v: pcu.digit_histogram(k, 3), ValueError),
    (lambda k, v: pcu.digit_histogram(k[::2], 0), ValueError),
    (lambda k, v: pcu.digit_rank(k, torch.zeros(8, dtype=torch.int32), 0), ValueError),
    (lambda k, v: pcu.digit_rank(k, torch.zeros(2048, dtype=torch.int64), 0), TypeError),
])
def test_sort_rejects_what_the_engines_do_not_take(call, exc):
    pk, pv = _port(*_kv("random", 8192, seed=1))
    with pytest.raises(exc):
        call(pk, pv)
