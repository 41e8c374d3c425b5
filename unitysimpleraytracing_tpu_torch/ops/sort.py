"""Key/value sort — the build's ordering primitive.

Counterpart of ``unitysimpleraytracing_tpu/ops/sort.py``.  The reference
implements a 4-pass, 8-bit-digit LSD radix sort as three HLSL kernels driven
from C# (``Assets/_Scripts/ComputeBufferSorter.cs:100-126``,
``Assets/_Shaders/Sorting/*.compute``).  Three engines sit behind one API:

- ``impl="torch"`` (the default): ``torch.sort(stable=True)`` with the values
  gathered along.  It is the one counterpart of the JAX package's ``"xla"``,
  ``"lex2"`` and ``"packed"`` engines, which are three lowerings of the same
  permutation.  Those two of them that drop the stable flag (``lex2``,
  ``packed``) equal the stable sort only when the carried values are
  distinct, although the JAX docstring promises stability for every engine;
  this engine is stable for any values.
- ``impl="radix"``: the reference's pass structure in plain tensor code —
  per-block digit histograms in the transposed (bucket-major) layout, an
  exclusive scan over the flattened histogram, destination = global bucket
  base + stable rank inside the block, one scatter per array.
- ``impl="cuda"``: the same decomposition with hand-written CUDA kernels for
  the histogram, the scan and the rank (``ops/sort_radix_cuda``, counterpart
  of the JAX package's ``"pallas"`` engine).

All three are stable, so their outputs are identical: the permutation of a
stable sort is unique.  Keys are int64 inside the port (non-negative, below
2^32; padding keys are ``KEY_PADDING`` = 0xFFFFFFFF and sort to the tail).
"""
from __future__ import annotations

import torch

from unitysimpleraytracing_tpu_torch import constants as C
from unitysimpleraytracing_tpu_torch.ops import scan

# Largest one-hot intermediate (elements) that the block-rank helper holds at
# a time: blocks are ranked in slabs of this many (key, bucket) cells.
_SLAB_CELLS = 1 << 24


def check_keys(keys: torch.Tensor, values: torch.Tensor | None = None) -> None:
    """Raise on keys (and carried values) that the radix engines do not take."""
    if keys.ndim != 1 or keys.shape[0] == 0:
        raise ValueError(f"keys must be a non-empty 1-D tensor, got shape {tuple(keys.shape)}")
    if keys.dtype != torch.int64:
        raise TypeError(f"keys must be int64 (the port's Morton convention), got {keys.dtype}")
    if keys.shape[0] >= 1 << 31:
        raise ValueError("radix sort takes fewer than 2^31 keys (int32 destinations)")
    if values is not None:
        if values.shape != keys.shape:
            raise ValueError(f"values {tuple(values.shape)} do not match keys {tuple(keys.shape)}")
        if values.device != keys.device:
            raise ValueError(f"values are on {values.device}, keys on {keys.device}")


def sort_key_val(
    keys: torch.Tensor, values: torch.Tensor, impl: str = "torch"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable ascending sort of ``keys`` with ``values`` carried along."""
    if impl == "torch":
        sorted_keys, perm = torch.sort(keys, stable=True)
        return sorted_keys, values[perm]
    if impl == "radix":
        return radix_sort_key_val(keys, values)
    if impl == "cuda":
        from unitysimpleraytracing_tpu_torch.ops import sort_radix_cuda

        return sort_radix_cuda.radix_sort_key_val_cuda(keys, values)
    raise ValueError(f"unknown sort impl {impl!r}")


def digit_of(keys: torch.Tensor, shift: int) -> torch.Tensor:
    """The pass's 8-bit digit of every key, int64."""
    return (keys >> shift) & (C.NUM_BUCKETS - 1)


def block_ranks(d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable rank inside its block and per-block histogram of the digits
    ``d`` (nblocks, block): ``(local_rank (nblocks, block) int32, hist
    (nblocks, NUM_BUCKETS) int32)``.

    One-hot digit occupancy and a running count along the block, as the
    reference obtains from its wave-scan local sort
    (LocalRadixSort.compute:64-91).  The one-hot tensor is 256 cells per key,
    so blocks are taken in slabs of at most 2^24 cells."""
    nblocks, block = d.shape
    buckets = torch.arange(C.NUM_BUCKETS, device=d.device)
    local_rank = torch.empty((nblocks, block), dtype=torch.int32, device=d.device)
    hist = torch.empty((nblocks, C.NUM_BUCKETS), dtype=torch.int32, device=d.device)
    slab = max(1, _SLAB_CELLS // (block * C.NUM_BUCKETS))
    for lo in range(0, nblocks, slab):
        ds = d[lo:lo + slab]
        onehot = (ds[:, :, None] == buckets).to(torch.int32)
        run = torch.cumsum(onehot, 1, dtype=torch.int32)
        local_rank[lo:lo + slab] = torch.gather(run, 2, ds[:, :, None])[:, :, 0] - 1
        hist[lo:lo + slab] = run[:, -1, :]
    return local_rank, hist


def _rank_pass(keys: torch.Tensor, shift: int, block: int):
    """Global stable rank of every element for one digit pass: ``(rank (n,)
    int32, hist_t, scanned)``.

    Mirrors the reference's decomposition: per-block bucket histograms written
    transposed (LocalRadixSort.compute:132: ``sizes[group + radix*BLOCK_SIZE]``)
    so a flat exclusive scan yields bucket-major global bases, plus the
    intra-block rank.  ``hist_t`` and ``scanned`` (both (NUM_BUCKETS·nblocks,)
    int32) are returned for the per-pass validators (the reference checks its
    sizesData and scan recurrence in situ per digit pass,
    ComputeBufferSorter.cs:226-271)."""
    n = keys.shape[0]
    if n % block:
        raise ValueError(f"n={n} must be a multiple of block={block}")
    nblocks = n // block
    d = digit_of(keys, shift).reshape(nblocks, block)
    local_rank, hist = block_ranks(d)
    hist_t = hist.t().reshape(-1)
    scanned = scan.exclusive_scan_plain(hist_t)
    block_ids = torch.arange(nblocks, device=keys.device)[:, None]
    base = scanned.reshape(C.NUM_BUCKETS, nblocks)[d, block_ids]
    return (base + local_rank).reshape(n), hist_t, scanned


def scatter_pass(keys, values, rank):
    """Realise one pass: element i moves to position ``rank[i]`` (a
    permutation), one scatter for the keys and one for the values."""
    index = rank.long()
    return (
        torch.empty_like(keys).scatter_(0, index, keys),
        torch.empty_like(values).scatter_(0, index, values),
    )


def pad_to_block(keys, values, block: int):
    """Pad to a block multiple with tail-sorting ``KEY_PADDING`` keys (the
    reference's padding convention, MeshBufferContainer.cs:108-109)."""
    pad = -keys.shape[0] % block
    if pad:
        keys = torch.cat([keys, keys.new_full((pad,), C.KEY_PADDING)])
        values = torch.cat([values, values.new_zeros((pad,))])
    return keys, values


@torch.no_grad()
def radix_sort_key_val(
    keys: torch.Tensor, values: torch.Tensor, block: int = C.SORT_BLOCK
) -> tuple[torch.Tensor, torch.Tensor]:
    """4-pass LSD radix sort (stable) of int64 keys + carried values, in plain
    tensor code.  ``block`` is clamped to the length; a length that is not a
    block multiple is padded with ``KEY_PADDING`` keys and sliced (the JAX
    engine asserts instead: scene capacities are multiples of 1024, not of
    4096)."""
    check_keys(keys, values)
    n = keys.shape[0]
    block = min(block, n)
    keys, values = pad_to_block(keys, values, block)
    for p in range(C.NUM_PASSES):
        rank, _, _ = _rank_pass(keys, p * C.RADIX_BITS, block)
        keys, values = scatter_pass(keys, values, rank)
    return keys[:n], values[:n]


@torch.no_grad()
def radix_pass_debug(
    keys: torch.Tensor, values: torch.Tensor, shift: int, block: int = C.SORT_BLOCK
):
    """ONE digit pass of the radix engine with its intermediates exposed:
    ``(keys_out, values_out, hist_t, scanned)`` where ``hist_t`` is the
    bucket-major flattened per-block histogram (the reference's transposed
    ``sizesData``, LocalRadixSort.compute:132) and ``scanned`` its exclusive
    scan (the ``scannedSizes`` the reference validates per pass,
    ComputeBufferSorter.cs:256-271).  The length must be a multiple of
    ``min(block, n)``.  Consumed by utils/validate.validate_sort_pass."""
    check_keys(keys, values)
    rank, hist_t, scanned = _rank_pass(keys, shift, min(block, keys.shape[0]))
    return (*scatter_pass(keys, values, rank), hist_t, scanned)


def argsort_by_key(keys: torch.Tensor, impl: str = "torch") -> torch.Tensor:
    """Stable permutation that sorts ``keys`` ascending (int32)."""
    idx = torch.arange(keys.shape[0], dtype=torch.int32, device=keys.device)
    _, perm = sort_key_val(keys, idx, impl=impl)
    return perm
