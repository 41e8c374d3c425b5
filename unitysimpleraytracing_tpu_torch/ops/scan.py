"""Exclusive prefix scan — the sort's bucket-base primitive.

Counterpart of ``unitysimpleraytracing_tpu/ops/scan_pallas.py``.  The TPU
kernel there is one launch whose grid steps run in order and carry a running
sum in scratch memory; on a GPU thread blocks run concurrently and in no
order, so the carry becomes a single-pass scan with decoupled look-back
(Merrill and Garland, 2016): each block takes a tile of 4096 elements from an
atomic ticket, scans it with warp shuffles, publishes its aggregate, looks
back over the tiles before it for their prefixes and publishes its own.

Kernel note.  `exclusive_scan` launches ``csrc/scan.cu``, the hand-written
CUDA kernel that replaces ``ops/scan_pallas.py::_kernel``: ONE launch per
call for every n, each element read once and written once.  It is bound by
bytes at large n (8 per int32 element) and, at the sort's sizes (16 to 64
tiles), by the launch and the look-back's dependent round trips to L2.  On an
H100 80GB HBM3 at 700 W, 262,144 int32 take 0.010 ms with a cold L2 against a
0.00063 ms byte bound and 0.011 ms for ``torch.cumsum``; the three-launch
form it replaces took 0.013 ms on the device and waited on the host between
its launches (``PERF.md``, ``benchmarks/kernel_ab.py``).  The look-back needs
scratch that reads as "not yet published" at the start of every call: a
status word per tile carries the call's epoch, and one device word holds the
epoch and the tickets drawn, which the block that draws the last ticket moves
to the next epoch.  Nothing is cleared between calls, and the host passes no
per-call state, so a call can be captured in a CUDA graph.  The scratch is
zero-filled when it is allocated — per device and stream, since two streams
must not share it — and again when a call needs more tiles than it has or
after 2^30 - 1 calls, before the 30-bit epoch of the status words comes round
(`ScanScratch`; calls replayed from a graph are not counted, and at one size
they write every status word they read).  int32 and int64 are
summed in their own type and are exact (there is no 2^24 limit as in the
float32-carried TPU kernel); they are bit-identical to `exclusive_scan_plain`.
float32 is summed in tree order, and the look-back adds predecessors in an
order that depends on which tiles had published, so float32 is NOT
reproducible from run to run in the last bits and agrees with a left-to-right
sum only to rounding.  `exclusive_scan_plain` is the same function as a
shifted ``torch.cumsum``; the CPU tests use it and ``chip_smoke.py`` holds the
kernel against it on the card.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from unitysimpleraytracing_tpu_torch.utils import kernel_build

KERNEL_NAME = "scan"
TILE = 4096  # elements per thread block: 256 threads x 16
_DTYPE_CODES = {torch.int32: 0, torch.int64: 1, torch.float32: 2}
# Status tags hold the epoch in 30 bits: the scratch is zero-filled again
# after this many calls.
CALLS_PER_FILL = (1 << 30) - 1


def tiles_of(n: int) -> int:
    """Thread blocks (tiles) of one call on ``n`` elements; the kernel takes
    1 <= n < 2^31."""
    if not 1 <= n < 1 << 31:
        raise ValueError(f"exclusive_scan takes 1 to 2^31 - 1 elements, got {n}")
    return -(-n // TILE)


class ScanScratch:
    """The look-back's scratch for one stream: a control word (epoch and
    tickets drawn, kept by the kernel) and three 64-bit words per tile (a
    status word per tile; for int64 also an aggregate and a prefix slot).

    `reserve` zero-fills the words when they are first allocated, when a
    call needs more tiles than they hold, and after `CALLS_PER_FILL` calls."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.capacity = 0       # tiles the words hold
        self.words = None       # int64 (1 + 3 * capacity,): control, then status
        self.calls = 0          # calls since the words were zero-filled

    def reserve(self, tiles: int):
        """(words, capacity) for a call of ``tiles`` tiles."""
        if tiles < 1:
            raise ValueError(f"a scan call has at least one tile, got {tiles}")
        if tiles > self.capacity:
            self.capacity = max(tiles, 2 * self.capacity)
            self.words = torch.zeros((1 + 3 * self.capacity,), dtype=torch.int64,
                                     device=self.device)
            self.calls = 0
        elif self.calls == CALLS_PER_FILL:
            self.words.zero_()
            self.calls = 0
        self.calls += 1
        return self.words, self.capacity


# (device index, stream handle) -> ScanScratch
_SCRATCH: dict = {}


def _check_input(x: torch.Tensor) -> None:
    if x.ndim != 1:
        raise ValueError(f"exclusive_scan expects a 1-D tensor, got shape {tuple(x.shape)}")
    if x.shape[0] == 0:
        raise ValueError("exclusive_scan of an empty tensor")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"exclusive_scan takes int32, int64 or float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("exclusive_scan input must be contiguous")


def exclusive_scan_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain version: ``out[i] = sum(x[:i])`` as a shifted cumulative sum,
    in the input's dtype."""
    _check_input(x)
    out = torch.zeros_like(x)
    out[1:] = torch.cumsum(x, 0, dtype=x.dtype)[:-1]
    return out


def _load_kernel():
    """The kernel's C entry point, built by nvcc on first use."""
    lib = kernel_build.load_kernel_library(KERNEL_NAME)
    fn = lib.scan_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _scan_on_card(x: torch.Tensor, fn, stream: int) -> torch.Tensor:
    """One launch of the look-back scan on the stream's scratch."""
    n = x.shape[0]
    key = (x.device.index, stream)
    scratch = _SCRATCH.get(key)
    if scratch is None:
        scratch = _SCRATCH[key] = ScanScratch(x.device)
    words, capacity = scratch.reserve(tiles_of(n))
    out = torch.empty_like(x)
    err = fn(x.data_ptr(), out.data_ptr(), words.data_ptr() + 8, words.data_ptr(),
             n, capacity, _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        # The words' state is unknown after a failed launch: start afresh.
        del _SCRATCH[key]
        raise RuntimeError(f"scan kernel launch failed: CUDA error {err}")
    exclusive_scan.device_launches += 1
    return out


@torch.no_grad()
def exclusive_scan(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum of a 1-D tensor (``out[i] = sum(x[:i])``), int32,
    int64 or float32, returned in the input's dtype.

    On a CUDA tensor this launches the hand-written kernel on the current
    stream without synchronising, or raises; it never gives way to the plain
    version.  On a CPU tensor it runs `exclusive_scan_plain`.
    ``exclusive_scan.launches`` counts the calls that went to the kernel and
    ``exclusive_scan.device_launches`` the kernel launches they made: one per
    call, for every n.  (The stream's scratch is zero-filled when it is first
    allocated or grown; that fill is not a kernel launch of this module.)
    A call can be captured in a CUDA graph: its arguments are the same on
    every replay, and the kernel keeps its state between calls on the
    device.
    """
    _check_input(x)
    if x.device.type == "cpu":
        return exclusive_scan_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    fn = _load_kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        out = _scan_on_card(x, fn, stream)
    exclusive_scan.launches += 1
    return out


exclusive_scan.launches = 0
exclusive_scan.device_launches = 0


def exclusive_scan_reference(x: np.ndarray) -> np.ndarray:
    """Host oracle (the reference's CPU validator recurrence,
    ComputeBufferSorter.cs:256-271)."""
    out = np.zeros_like(x)
    out[1:] = np.cumsum(x)[:-1]
    return out
