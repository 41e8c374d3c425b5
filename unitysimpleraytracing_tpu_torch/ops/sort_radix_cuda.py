"""Radix sort on hand-written CUDA kernels — the ``"cuda"`` sort engine.

Counterpart of ``unitysimpleraytracing_tpu/ops/sort_pallas.py``.  The
reference's 4-pass LSD radix sort is three GPU kernels built on wave
intrinsics and shared-memory tiles (``LocalRadixSort.compute``,
``Scan.compute``, ``GlobalRadixSort.compute``; orchestration
``ComputeBufferSorter.cs:100-126``).  Here a sort is five launches and no
host read-back (Onesweep, Adinets and Merrill, 2022):

- **Count** (`digit_counts`, K3): one launch reads every key once and counts
  the digits of all four passes, ``counts[p * 256 + d]``.  A permutation does
  not change the digit totals, so they are counted once, from the unsorted
  keys.
- **Scan** (`ops/scan.exclusive_scan`, K5): the flat exclusive scan of those
  1024 counts; pass ``p`` finds digit ``d``'s first output position at
  ``bases[p * 256 + d] - p * n``.
- **Pass** (`digit_pass`, K4), once per digit: each thread block takes a tile
  of 4096 keys from an atomic ticket, ranks its keys stably by position,
  learns each digit's count in the earlier tiles by decoupled look-back over
  per-(tile, digit) status words, and writes keys and values to their places,
  each digit's run as consecutive addresses.

`digit_histogram` (per-1024-key-block histogram of one digit, bucket-major,
``hist_t[bucket * nblocks + block]``) and `digit_rank` (destinations from
given bucket-major per-block bases) are the same two kernel bodies
instantiated for one digit without the look-back; they are the per-block
observables that the validators and the JAX package's ``_hist_kernel`` and
``_rank_kernel`` define.  `digit_pass` writes the same observables (``dst``,
``hist_t``, ``scanned``) when asked, so `cuda_pass_debug` returns what the
per-pass validators check.

Kernel note.  The wrappers launch ``csrc/radix_sort.cu``, the hand-written
CUDA kernels that replace ``ops/sort_pallas.py::_hist_kernel`` (the count and
`digit_histogram`) and ``::_rank_kernel`` (the pass and `digit_rank`).  The TPU
kernels count with one-hot matrices and triangular-ones matrix products in
float32 (exact below 2^24 keys); these count in int32 with
``__match_any_sync`` and ``__popc``, so the only limit is ``n < 2^31``
(int32 destinations), which raises ``ValueError``.  Values are any 4-byte
type, moved as bits; another width raises ``TypeError``.  The kernels are
bound by bytes: 8 a key for the count, 24 a key for a pass (keys and values
read once and written once), plus 2 KB of status words a tile.  The
look-back's status words carry the launch's epoch, and the count leaves its
running totals at zero, so nothing is cleared between calls and a sort can
be captured in a CUDA graph; the words live in one `ScanScratch` per device
and stream (``ops/scan.py`` says how it grows and what a capture keeps).  On
a CUDA tensor every wrapper launches its kernel or raises; on a CPU tensor
it runs its plain version (`digit_counts_plain`, `digit_pass_plain`,
`digit_histogram_plain`, `digit_rank_plain`), which the CPU tests use and
``chip_smoke.py`` holds the kernels against bit for bit on the card.
"""
from __future__ import annotations

import ctypes

import torch

from unitysimpleraytracing_tpu_torch import constants as C
from unitysimpleraytracing_tpu_torch.ops import scan, sort
from unitysimpleraytracing_tpu_torch.utils import kernel_build

KERNEL_NAME = "radix_sort"
BLOCK = 1024  # keys per block of the per-block observables (hist_t, scanned, digit_rank)
TILE = 4096   # keys per thread block of a pass (csrc/radix_sort.cu: THREADS * PASS_ITEMS)
_NB = C.NUM_BUCKETS
SHIFTS = tuple(p * C.RADIX_BITS for p in range(C.NUM_PASSES))
# The sort's scratch, in 64-bit words: the pass's control word, the count's
# ticket, the count's 1024 running totals (32-bit), then 256 status words a tile.
_HEAD_WORDS = 2 + C.NUM_PASSES * _NB // 2
_STATUS_OFFSET = 8 * _HEAD_WORDS  # bytes


def _check_block_keys(keys: torch.Tensor, shift: int) -> int:
    """Raise on anything the per-block kernels do not take; returns the
    block count."""
    _check_keys(keys, shift)
    if keys.shape[0] % BLOCK:
        raise ValueError(f"{keys.shape[0]} keys: not a multiple of {BLOCK} (pad with KEY_PADDING)")
    return keys.shape[0] // BLOCK


def _check_keys(keys: torch.Tensor, shift: int = 0) -> None:
    sort.check_keys(keys)
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")
    if shift not in SHIFTS:
        raise ValueError(f"shift must be one of 0, 8, 16, 24, got {shift}")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {keys.device}")


def _check_values(keys: torch.Tensor, values: torch.Tensor) -> None:
    sort.check_keys(keys, values)
    if values.element_size() != 4:
        raise TypeError(f"values must be a 4-byte type (moved as bits), got {values.dtype}")
    if not values.is_contiguous():
        raise ValueError("values must be contiguous")


def _load_kernel():
    """The kernels' C entry points, built by nvcc on first use:
    ``(count, histogram, pass, rank)``."""
    lib = kernel_build.load_kernel_library(KERNEL_NAME)
    count, hist = lib.digit_count_launch, lib.digit_histogram_launch
    pass_, rank = lib.digit_pass_launch, lib.digit_rank_launch
    if count.argtypes is None:
        count.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
        hist.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        pass_.argtypes = [ctypes.c_void_p] * 10 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        rank.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        for fn in (count, hist, pass_, rank):
            fn.restype = ctypes.c_int
    return count, hist, pass_, rank


# (device index, stream handle) -> the sort's ScanScratch
_SCRATCH: dict = {}


def _stream_scratch(device: torch.device, stream: int, tiles: int, epochs: int):
    """(key into _SCRATCH, words, capacity) of this stream's scratch, grown
    to ``tiles`` pass tiles."""
    key = (device.index, stream)
    scratch = _SCRATCH.get(key)
    if scratch is None:
        scratch = _SCRATCH[key] = scan.ScanScratch(device, words_per_tile=_NB,
                                                   head=_HEAD_WORDS)
    words, capacity = scratch.reserve(
        tiles, capturing=torch.cuda.is_current_stream_capturing(), epochs=epochs)
    return key, words, capacity


def _check_launch(name: str, err: int, scratch_key) -> None:
    """Raise if a launch that used the stream's scratch failed."""
    if err != 0:
        # The words' state is unknown after a failed launch: start afresh.
        _SCRATCH.pop(scratch_key, None)
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _padded(keys: torch.Tensor):
    """Keys padded to a multiple of BLOCK with KEY_PADDING, and the pad."""
    pad = -keys.shape[0] % BLOCK
    if pad:
        keys = torch.cat([keys, keys.new_full((pad,), C.KEY_PADDING)])
    return keys, pad


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
    this launches the count kernel's one-digit form on the current stream
    without synchronising, or raises; it never gives way to the plain
    version.  On a CPU tensor it runs `digit_histogram_plain`.
    ``digit_histogram.launches`` counts kernel launches.
    """
    nblocks = _check_block_keys(keys, shift)
    if keys.device.type == "cpu":
        return digit_histogram_plain(keys, shift)
    _, launch, _, _ = _load_kernel()
    hist_t = torch.empty((_NB * nblocks,), dtype=torch.int32, device=keys.device)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        err = launch(keys.data_ptr(), hist_t.data_ptr(), nblocks, shift, stream)
    if err != 0:
        raise RuntimeError(f"digit_histogram kernel launch failed: CUDA error {err}")
    digit_histogram.launches += 1
    return hist_t


digit_histogram.launches = 0


def digit_counts_plain(keys: torch.Tensor) -> torch.Tensor:
    """The plain version of `digit_counts`: per pass, the sum over blocks of
    `digit_histogram_plain` of the keys padded to a block multiple, less the
    padding keys (digit 255 in every pass)."""
    _check_keys(keys)
    padded, pad = _padded(keys)
    rows = []
    for shift in SHIFTS:
        row = digit_histogram_plain(padded, shift).reshape(_NB, -1).sum(1, dtype=torch.int32)
        row[_NB - 1] -= pad
        rows.append(row)
    return torch.cat(rows)


@torch.no_grad()
def digit_counts(keys: torch.Tensor) -> torch.Tensor:
    """How many keys hold each digit in each of the four passes: ``counts``
    (1024,) int32, ``counts[p * 256 + d]`` = number of keys with
    ``(key >> 8 p) & 255 == d``.

    ``keys``: contiguous int64, any length below 2^31.  On a CUDA tensor this
    launches the count kernel (one launch, every key read once) on the
    current stream without synchronising, or raises; it never gives way to
    the plain version.  On a CPU tensor it runs `digit_counts_plain`.
    ``digit_counts.launches`` counts kernel launches.
    """
    _check_keys(keys)
    if keys.device.type == "cpu":
        return digit_counts_plain(keys)
    launch, _, _, _ = _load_kernel()
    counts = torch.empty((C.NUM_PASSES * _NB,), dtype=torch.int32, device=keys.device)
    n = keys.shape[0]
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        # Sized for the passes over the same keys, so that they do not grow it.
        key, words, _ = _stream_scratch(keys.device, stream, -(-n // TILE), epochs=0)
        _check_launch("digit_counts",
                      launch(keys.data_ptr(), counts.data_ptr(), words.data_ptr() + 8, n, stream),
                      key)
    digit_counts.launches += 1
    return counts


digit_counts.launches = 0


def _check_bases(keys: torch.Tensor, bases: torch.Tensor, length: int) -> None:
    if bases.dtype != torch.int32:
        raise TypeError(f"bases must be int32, got {bases.dtype}")
    if tuple(bases.shape) != (length,):
        raise ValueError(f"bases must have shape ({length},), got {tuple(bases.shape)}")
    if not bases.is_contiguous():
        raise ValueError("bases must be contiguous")
    if bases.device != keys.device:
        raise ValueError(f"bases are on {bases.device}, keys on {keys.device}")


def digit_rank_plain(keys: torch.Tensor, bases: torch.Tensor, shift: int) -> torch.Tensor:
    """The plain version of `digit_rank`: one-hot running counts per block
    (`ops/sort.block_ranks`, in slabs) plus a gather of the bases."""
    nblocks = _check_block_keys(keys, shift)
    _check_bases(keys, bases, _NB * nblocks)
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
    (256·nblocks,), bucket-major.  On a CUDA tensor this launches the pass
    kernel's rank-only form on the current stream without synchronising, or
    raises; it never gives way to the plain version.  On a CPU tensor it runs
    `digit_rank_plain`.  ``digit_rank.launches`` counts kernel launches.
    """
    nblocks = _check_block_keys(keys, shift)
    _check_bases(keys, bases, _NB * nblocks)
    if keys.device.type == "cpu":
        return digit_rank_plain(keys, bases, shift)
    _, _, _, launch = _load_kernel()
    dst = torch.empty((keys.shape[0],), dtype=torch.int32, device=keys.device)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        err = launch(keys.data_ptr(), bases.data_ptr(), dst.data_ptr(), nblocks, shift, stream)
    if err != 0:
        raise RuntimeError(f"digit_rank kernel launch failed: CUDA error {err}")
    digit_rank.launches += 1
    return dst


digit_rank.launches = 0


def digit_pass_plain(keys: torch.Tensor, values: torch.Tensor, bases: torch.Tensor,
                     shift: int):
    """The plain version of `digit_pass` with every observable: ``(keys_out,
    values_out, dst, hist_t, scanned)``.  The keys are padded to a block
    multiple for `digit_histogram_plain` and `digit_rank_plain` (the padding
    keys, digit 255, come after every real key and are taken out of the last
    block's count); each block's bases are the pass's digit base from
    ``bases`` plus the digit's count in earlier blocks; `ops/sort.scatter_pass`
    moves the keys and values."""
    _check_keys(keys, shift)
    _check_values(keys, values)
    _check_bases(keys, bases, C.NUM_PASSES * _NB)
    n = keys.shape[0]
    padded, pad = _padded(keys)
    nblocks = padded.shape[0] // BLOCK
    hist_t = digit_histogram_plain(padded, shift)
    hist_t[_NB * nblocks - 1] -= pad
    p = shift // C.RADIX_BITS
    digit_base = ((bases[p * _NB:(p + 1) * _NB].long() - p * n) % (1 << 32)).int()
    hist = hist_t.reshape(_NB, nblocks)
    earlier = torch.cumsum(hist, 1, dtype=torch.int32) - hist
    scanned = (digit_base[:, None] + earlier).reshape(-1)
    dst = digit_rank_plain(padded, scanned, shift)[:n]
    keys_out, values_out = sort.scatter_pass(keys, values, dst)
    return keys_out, values_out, dst, hist_t, scanned


@torch.no_grad()
def digit_pass(keys: torch.Tensor, values: torch.Tensor, bases: torch.Tensor, shift: int,
               observe: bool = False):
    """One stable digit pass: ``(keys_out, values_out)``, the keys and values
    stably sorted by ``(key >> shift) & 255``; with ``observe`` also ``dst``
    (n,) (where each key went), ``hist_t`` and ``scanned`` ((256·nblocks,),
    per 1024-key block, bucket-major: the histogram and its flat exclusive
    scan), all int32.

    ``keys``: contiguous int64, any length below 2^31; ``values``: the same
    length, any 4-byte type; ``bases``: (1024,) int32, the exclusive scan of
    `digit_counts` of these keys (or of any permutation of them; other bases
    that would move a key past the output stop the kernel with a trap).  On a
    CUDA tensor this launches the pass kernel on the current stream without
    synchronising, or raises; it never gives way to the plain version.  On a
    CPU tensor it runs `digit_pass_plain`.  ``digit_pass.launches`` counts
    kernel launches.
    """
    _check_keys(keys, shift)
    _check_values(keys, values)
    _check_bases(keys, bases, C.NUM_PASSES * _NB)
    if keys.device.type == "cpu":
        out = digit_pass_plain(keys, values, bases, shift)
        return out if observe else out[:2]
    _, _, launch, _ = _load_kernel()
    n = keys.shape[0]
    keys_out, values_out = torch.empty_like(keys), torch.empty_like(values)
    seen = ()
    if observe:
        nblocks = -(-n // BLOCK)
        seen = (torch.empty((n,), dtype=torch.int32, device=keys.device),
                *(torch.empty((_NB * nblocks,), dtype=torch.int32, device=keys.device)
                  for _ in range(2)))
    ptrs = [t.data_ptr() for t in seen] or [None] * 3
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        key, words, capacity = _stream_scratch(keys.device, stream, -(-n // TILE), epochs=1)
        _check_launch("digit_pass", launch(
            keys.data_ptr(), values.data_ptr(), keys_out.data_ptr(), values_out.data_ptr(),
            bases.data_ptr(), *ptrs, words.data_ptr() + _STATUS_OFFSET, words.data_ptr(), n,
            capacity, shift, stream), key)
    digit_pass.launches += 1
    return (keys_out, values_out, *seen)


digit_pass.launches = 0


def _sort_pass(keys, values, shift: int):
    """One digit pass with its observables: ``(keys_out, values_out, hist_t,
    scanned, dst)`` — the count, the scan of the counts and the pass."""
    bases = scan.exclusive_scan(digit_counts(keys))
    keys_out, values_out, dst, hist_t, scanned = digit_pass(keys, values, bases, shift,
                                                            observe=True)
    return keys_out, values_out, hist_t, scanned, dst


@torch.no_grad()
def radix_sort_key_val_cuda(
    keys: torch.Tensor, values: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable 4-pass LSD radix sort of int64 keys with carried 4-byte values.

    Any length below 2^31, no padding: `digit_counts` → `exclusive_scan` of
    the 1024 counts → four `digit_pass` launches, six launches in all and no
    host read-back, so a sort can be captured in a CUDA graph.  On CPU
    tensors the three wrappers run their plain versions.
    """
    sort.check_keys(keys, values)
    keys, values = keys.contiguous(), values.contiguous()
    _check_values(keys, values)
    if keys.device.type == "cpu":
        bases = scan.exclusive_scan(digit_counts(keys))
        for shift in SHIFTS:
            keys, values = digit_pass(keys, values, bases, shift)
        return keys, values
    return _sort_on_card(keys, values)


def _sort_on_card(keys: torch.Tensor, values: torch.Tensor):
    """`digit_counts`, `exclusive_scan` and four `digit_pass` launches with the
    host's share done once: one device context, one look-up of the stream's
    scratch for all four epochs, and two output buffers taken in turns."""
    count, _, launch, _ = _load_kernel()
    n = keys.shape[0]
    counts = torch.empty((C.NUM_PASSES * _NB,), dtype=torch.int32, device=keys.device)
    buffers = [(torch.empty_like(keys), torch.empty_like(values)) for _ in range(2)]
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        key, words, capacity = _stream_scratch(keys.device, stream, -(-n // TILE),
                                               epochs=C.NUM_PASSES)
        control = words.data_ptr()
        _check_launch("digit_counts",
                      count(keys.data_ptr(), counts.data_ptr(), control + 8, n, stream), key)
        digit_counts.launches += 1
        bases = scan.exclusive_scan(counts)
        for i, shift in enumerate(SHIFTS):
            keys_out, values_out = buffers[i % 2]
            _check_launch("digit_pass", launch(
                keys.data_ptr(), values.data_ptr(), keys_out.data_ptr(), values_out.data_ptr(),
                bases.data_ptr(), None, None, None, control + _STATUS_OFFSET, control, n,
                capacity, shift, stream), key)
            digit_pass.launches += 1
            keys, values = keys_out, values_out
    return keys, values


@torch.no_grad()
def cuda_pass_debug(keys: torch.Tensor, values: torch.Tensor, shift: int):
    """ONE digit pass of this engine with intermediates: ``(keys_out,
    values_out, hist_t, scanned)`` in the same form as
    ops/sort.radix_pass_debug (the length must be a multiple of 1024 — pad
    with KEY_PADDING first like ``utils/validate.validate_sort_per_pass``
    does)."""
    sort.check_keys(keys, values)
    _check_block_keys(keys, shift)
    return _sort_pass(keys, values, shift)[:4]
