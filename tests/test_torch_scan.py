"""Exclusive scan of the PyTorch port against the JAX package's Pallas scan
(interpret mode on the CPU) and the host oracle.

Tolerances: integer scans bit-identical.  float32: |got - want| <= 1e-5 x the
running sum of magnitudes (at least 1): the three implementations sum in
different orders (a matmul per 128 lanes, a serial or blocked cumsum)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unitysimpleraytracing_tpu.ops import scan_pallas
from unitysimpleraytracing_tpu_torch.ops import scan as pscan

from _torch_common import assert_same_bits, n_, t_


def _ints(n, dtype=np.int32):
    return np.random.default_rng(n).integers(0, 9, size=n).astype(dtype)


@pytest.mark.parametrize("n", [1, 1024, 4096, 5000, 131072])
def test_exclusive_scan_int_bit_identical(n):
    x = _ints(n)
    want = scan_pallas.exclusive_scan(jnp.asarray(x))
    got = pscan.exclusive_scan(t_(x))
    assert got.dtype == torch.int32
    assert_same_bits(got, want, "scan")
    assert_same_bits(got, scan_pallas.exclusive_scan_reference(x), "oracle")


def test_exclusive_scan_histogram_shape_bit_identical():
    # The sort's actual use: 256-bucket x nblocks transposed histogram.
    rng = np.random.default_rng(0)
    flat = rng.integers(0, 1024, size=(256, 64)).astype(np.int32).reshape(-1)
    want = scan_pallas.exclusive_scan(jnp.asarray(flat))
    assert_same_bits(pscan.exclusive_scan(t_(flat)), want, "histogram scan")


@pytest.mark.parametrize("n", [1, 1025, 70000])
def test_exclusive_scan_int64_is_exact_beyond_float32(n):
    # Totals above 2^24, where the float32-carried TPU kernel stops being
    # exact: the port sums in the input's own type.
    x = np.random.default_rng(n).integers(0, 1 << 40, size=n).astype(np.int64)
    got = pscan.exclusive_scan(t_(x))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(n_(got), pscan.exclusive_scan_reference(x))


@pytest.mark.parametrize("n", [1, 4096, 5000])
def test_exclusive_scan_float_within_tolerance(n):
    x = np.random.default_rng(1).normal(size=n).astype(np.float32)
    want64 = pscan.exclusive_scan_reference(x.astype(np.float64))
    bound = 1e-5 * np.maximum(
        pscan.exclusive_scan_reference(np.abs(x).astype(np.float64)), 1.0)
    got = n_(pscan.exclusive_scan(t_(x)))
    jax_got = n_(scan_pallas.exclusive_scan(jnp.asarray(x)))
    assert got.dtype == np.float32
    assert np.all(np.abs(got - want64) <= bound)
    assert np.all(np.abs(got - jax_got) <= bound)


def test_oracles_agree():
    x = _ints(3000)
    np.testing.assert_array_equal(
        pscan.exclusive_scan_reference(x), scan_pallas.exclusive_scan_reference(x))


def test_wrapper_on_cpu_is_the_plain_version_and_counts_no_launch():
    x = t_(_ints(5000))
    calls, dev = pscan.exclusive_scan.launches, pscan.exclusive_scan.device_launches
    assert torch.equal(pscan.exclusive_scan(x), pscan.exclusive_scan_plain(x))
    assert pscan.exclusive_scan.launches == calls == 0
    assert pscan.exclusive_scan.device_launches == dev == 0


@pytest.mark.parametrize("bad, exc", [
    (lambda: torch.zeros((4, 4), dtype=torch.int32), ValueError),
    (lambda: torch.zeros((0,), dtype=torch.int32), ValueError),
    (lambda: torch.zeros((8,), dtype=torch.float64), TypeError),
    (lambda: torch.zeros((8,), dtype=torch.int16), TypeError),
    (lambda: torch.zeros((16,), dtype=torch.int32)[::2], ValueError),
])
def test_exclusive_scan_rejects_what_the_kernel_does_not_take(bad, exc):
    with pytest.raises(exc):
        pscan.exclusive_scan(bad())
    with pytest.raises(exc):
        pscan.exclusive_scan_plain(bad())
