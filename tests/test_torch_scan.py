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


# ---- the one-launch look-back kernel's bookkeeping (no card needed) ---------------


@pytest.mark.parametrize("n, tiles", [
    (1, 1), (4095, 1), (4096, 1), (4097, 2), (65280, 16), (262144, 64),
    ((1 << 22) + 3, 1025), ((1 << 31) - 1, 1 << 19),
])
def test_tile_count_of_one_call(n, tiles):
    assert pscan.tiles_of(n) == tiles
    assert pscan.TILE == 4096


@pytest.mark.parametrize("n", [0, -1, 1 << 31])
def test_tile_count_rejects_what_the_kernel_does_not_take(n):
    with pytest.raises(ValueError):
        pscan.tiles_of(n)


def test_scratch_is_sized_by_tiles_and_passes_no_per_call_state():
    """The host gives every call of one size the same words and capacity
    (the epoch and the tickets live in the control word on the device), so a
    captured call replays with the arguments it was captured with."""
    sc = pscan.ScanScratch("cpu")
    words, cap = sc.reserve(16)
    assert cap == 16 and sc.calls == 1
    assert words.dtype == torch.int64 and words.shape == (1 + 3 * 16,)
    assert not bool(words.any())  # zero-filled: no status word reads as published
    # Calls that fit keep the words.
    for tiles in (3, 16, 1):
        assert sc.reserve(tiles) == (words, 16)
    # A call with more tiles grows the words (zero-filled again).
    w, c = sc.reserve(17)
    assert w is not words and c == 32 and not bool(w.any()) and sc.calls == 1
    assert w.shape == (1 + 3 * 32,)
    with pytest.raises(ValueError):
        sc.reserve(0)


def test_scratch_starts_afresh_before_the_epochs_run_out():
    """After `CALLS_PER_FILL` calls the same words are zero-filled in place,
    before a status word's 30-bit epoch can come round to this call's."""
    assert pscan.CALLS_PER_FILL == (1 << 30) - 1
    sc = pscan.ScanScratch("cpu")
    words, _ = sc.reserve(4)
    words[1:] = 7  # stand-in for status words left by earlier calls
    sc.calls = pscan.CALLS_PER_FILL - 1
    w, _ = sc.reserve(4)
    assert w is words and bool((w[1:] == 7).all()) and sc.calls == pscan.CALLS_PER_FILL
    w, _ = sc.reserve(4)
    assert w is words and not bool(w.any()) and sc.calls == 1


def test_wrapper_raises_on_a_device_it_has_no_kernel_for():
    with pytest.raises(ValueError, match="unsupported device"):
        pscan.exclusive_scan(torch.zeros(8, dtype=torch.int32, device="meta"))
