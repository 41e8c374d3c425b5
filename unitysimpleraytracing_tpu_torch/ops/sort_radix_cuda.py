"""Radix sort on hand-written CUDA kernels — the ``"cuda"`` sort engine.

Counterpart of ``unitysimpleraytracing_tpu/ops/sort_pallas.py``.  The
reference's 4-pass LSD radix sort is three GPU kernels built on wave
intrinsics and shared-memory tiles (``LocalRadixSort.compute``,
``Scan.compute``, ``GlobalRadixSort.compute``; orchestration
``ComputeBufferSorter.cs:100-126``).  One digit pass here is:

- **Histogram kernel** (`digit_histogram`): per 1024-key block, the
  256-bucket histogram of the pass's digit, written straight into the
  reference's transposed layout ``hist_t[bucket * nblocks + block]``
  (LocalRadixSort.compute:132).
- **Scan** (`ops/scan.exclusive_scan`): the flat exclusive scan of that
  bucket-major histogram is, for every (bucket, block), the global position
  of the block's first key of that bucket.
- **Rank kernel** (`digit_rank`): destination of every key = that base + the
  number of earlier keys of the same digit in its block (stable).
- **Scatter**: keys and values move to their destinations with one
  ``Tensor.scatter_`` each, in plain PyTorch.  This is the one realisation of
  the pass that is ported; the JAX package's two (scatter-of-iota plus two
  gathers, and a fused pair scatter) exist because of how a TPU scatters.

Kernel note.  `digit_histogram` and `digit_rank` launch
``csrc/radix_sort.cu``, the hand-written CUDA kernels that replace
``ops/sort_pallas.py::_hist_kernel`` and ``::_rank_kernel``.  The TPU kernels
count with one-hot matrices and triangular-ones matrix products in float32
(exact below 2^24 keys); these count in int32 with ``__match_any_sync`` and
``__popc``, so the only limit is ``n < 2^31`` (int32 destinations), which
raises ``ValueError``.  Both kernels are bound by bytes: 8 per key read, plus
1 KB per block written (histogram) or read (bases), plus 4 per key written
(destinations).  `digit_histogram_plain` and `digit_rank_plain` are the same
functions in plain tensor code; the CPU tests use them and ``chip_smoke.py``
holds the kernels against them bit for bit on the card.
"""
from __future__ import annotations

import ctypes

import torch

from unitysimpleraytracing_tpu_torch import constants as C
from unitysimpleraytracing_tpu_torch.ops import scan, sort
from unitysimpleraytracing_tpu_torch.utils import kernel_build

KERNEL_NAME = "radix_sort"
BLOCK = 1024  # keys per thread block
_NB = C.NUM_BUCKETS


def _check_block_keys(keys: torch.Tensor, shift: int) -> int:
    """Raise on anything the kernels do not take; returns the block count."""
    sort.check_keys(keys)
    if keys.shape[0] % BLOCK:
        raise ValueError(f"{keys.shape[0]} keys: not a multiple of {BLOCK} (pad with KEY_PADDING)")
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")
    if shift not in range(0, C.KEY_BITS, C.RADIX_BITS):
        raise ValueError(f"shift must be one of 0, 8, 16, 24, got {shift}")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {keys.device}")
    return keys.shape[0] // BLOCK


def _load_kernel():
    """The kernels' C entry points, built by nvcc on first use."""
    lib = kernel_build.load_kernel_library(KERNEL_NAME)
    hist, rank = lib.digit_histogram_launch, lib.digit_rank_launch
    if hist.argtypes is None:
        hist.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        hist.restype = ctypes.c_int
        rank.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        rank.restype = ctypes.c_int
    return hist, rank


def digit_histogram_plain(keys: torch.Tensor, shift: int) -> torch.Tensor:
    """The plain version of `digit_histogram`: a scatter-add of ones per
    block, transposed to the bucket-major layout."""
    nblocks = _check_block_keys(keys, shift)
    d = sort.digit_of(keys, shift).reshape(nblocks, BLOCK)
    hist = torch.zeros((nblocks, _NB), dtype=torch.int32, device=keys.device)
    hist.scatter_add_(1, d, torch.ones_like(d, dtype=torch.int32))
    return hist.t().reshape(-1)


@torch.no_grad()
def digit_histogram(keys: torch.Tensor, shift: int) -> torch.Tensor:
    """Per 1024-key block, the 256-bucket histogram of the digit
    ``(key >> shift) & 255``: ``hist_t`` (256·nblocks,) int32, bucket-major
    (``hist_t[bucket * nblocks + block]``).

    ``keys``: contiguous int64, a multiple of 1024 long.  On a CUDA tensor
    this launches the hand-written kernel on the current stream without
    synchronising, or raises; it never gives way to the plain version.  On a
    CPU tensor it runs `digit_histogram_plain`.  ``digit_histogram.launches``
    counts kernel launches.
    """
    nblocks = _check_block_keys(keys, shift)
    if keys.device.type == "cpu":
        return digit_histogram_plain(keys, shift)
    launch, _ = _load_kernel()
    hist_t = torch.empty((_NB * nblocks,), dtype=torch.int32, device=keys.device)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        err = launch(keys.data_ptr(), hist_t.data_ptr(), nblocks, shift, stream)
    if err != 0:
        raise RuntimeError(f"digit_histogram kernel launch failed: CUDA error {err}")
    digit_histogram.launches += 1
    return hist_t


digit_histogram.launches = 0


def _check_bases(keys: torch.Tensor, bases: torch.Tensor, nblocks: int) -> None:
    if bases.dtype != torch.int32:
        raise TypeError(f"bases must be int32, got {bases.dtype}")
    if tuple(bases.shape) != (_NB * nblocks,):
        raise ValueError(f"bases must have shape ({_NB * nblocks},), got {tuple(bases.shape)}")
    if not bases.is_contiguous():
        raise ValueError("bases must be contiguous")
    if bases.device != keys.device:
        raise ValueError(f"bases are on {bases.device}, keys on {keys.device}")


def digit_rank_plain(keys: torch.Tensor, bases: torch.Tensor, shift: int) -> torch.Tensor:
    """The plain version of `digit_rank`: one-hot running counts per block
    (`ops/sort.block_ranks`, in slabs) plus a gather of the bases."""
    nblocks = _check_block_keys(keys, shift)
    _check_bases(keys, bases, nblocks)
    d = sort.digit_of(keys, shift).reshape(nblocks, BLOCK)
    local_rank, _ = sort.block_ranks(d)
    block_ids = torch.arange(nblocks, device=keys.device)[:, None]
    base = bases.reshape(_NB, nblocks)[d, block_ids]
    return (base + local_rank).reshape(-1)


@torch.no_grad()
def digit_rank(keys: torch.Tensor, bases: torch.Tensor, shift: int) -> torch.Tensor:
    """Destination of every key for one stable digit pass: ``dst`` (n,) int32,
    ``dst[i] = bases[digit_i * nblocks + block_i] + (number of earlier keys
    of the same digit in the block)`` — a permutation of ``0..n-1`` when
    ``bases`` is the exclusive scan of `digit_histogram`'s output.

    ``keys`` as for `digit_histogram`; ``bases`` contiguous int32
    (256·nblocks,), bucket-major.  On a CUDA tensor this launches the
    hand-written kernel on the current stream without synchronising, or
    raises; it never gives way to the plain version.  On a CPU tensor it runs
    `digit_rank_plain`.  ``digit_rank.launches`` counts kernel launches.
    """
    nblocks = _check_block_keys(keys, shift)
    _check_bases(keys, bases, nblocks)
    if keys.device.type == "cpu":
        return digit_rank_plain(keys, bases, shift)
    _, launch = _load_kernel()
    dst = torch.empty((keys.shape[0],), dtype=torch.int32, device=keys.device)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        err = launch(keys.data_ptr(), bases.data_ptr(), dst.data_ptr(), nblocks, shift, stream)
    if err != 0:
        raise RuntimeError(f"digit_rank kernel launch failed: CUDA error {err}")
    digit_rank.launches += 1
    return dst


digit_rank.launches = 0


def _sort_pass(keys, values, shift: int):
    """One digit pass on block-padded arrays: ``(keys_out, values_out, hist_t,
    scanned, dst)``."""
    hist_t = digit_histogram(keys, shift)
    # Transposed-histogram scan (LocalRadixSort.compute:132's layout): the
    # flat exclusive scan is the per-(bucket, block) global base.
    scanned = scan.exclusive_scan(hist_t)
    dst = digit_rank(keys, scanned, shift)
    return (*sort.scatter_pass(keys, values, dst), hist_t, scanned, dst)


@torch.no_grad()
def radix_sort_key_val_cuda(
    keys: torch.Tensor, values: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable 4-pass LSD radix sort of int64 keys with carried values.

    Arbitrary lengths below 2^31 are handled by padding to a multiple of 1024
    with 0xFFFFFFFF keys (they sort to the tail, MeshBufferContainer.cs:108-109's
    convention) and slicing the result.  Each pass is `digit_histogram` →
    `exclusive_scan` → `digit_rank` → two scatters (see module doc); on CPU
    tensors the three wrappers run their plain versions.
    """
    sort.check_keys(keys, values)
    n = keys.shape[0]
    keys, values = sort.pad_to_block(keys.contiguous(), values, BLOCK)
    for p in range(C.NUM_PASSES):
        keys, values, _, _, _ = _sort_pass(keys, values, p * C.RADIX_BITS)
    return keys[:n], values[:n]


@torch.no_grad()
def cuda_pass_debug(keys: torch.Tensor, values: torch.Tensor, shift: int):
    """ONE digit pass of this engine with intermediates: ``(keys_out,
    values_out, hist_t, scanned)`` in the same form as
    ops/sort.radix_pass_debug (the length must be a multiple of 1024 — pad
    with KEY_PADDING first like `radix_sort_key_val_cuda` does)."""
    sort.check_keys(keys, values)
    return _sort_pass(keys, values, shift)[:4]
