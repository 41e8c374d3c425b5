"""Exclusive prefix scan — the sort's bucket-base primitive.

Counterpart of ``unitysimpleraytracing_tpu/ops/scan_pallas.py``.  The TPU
kernel there is one launch whose grid steps run in order and carry a running
sum in scratch memory; on a GPU thread blocks run concurrently, so the scan
goes back to the reference's own three-stage form (PreScan → BlockSum →
GlobalScan, ``Assets/_Shaders/Sorting/Scan.compute:15-96``): every block scans
its 1024-element chunk with warp shuffles and writes the chunk total, the
totals are scanned the same way (recursively while more than one chunk of
totals is left), and every chunk adds its base.

Kernel note.  `exclusive_scan` launches ``csrc/scan.cu``, the hand-written
CUDA kernels that replace ``ops/scan_pallas.py::_kernel``.  The scan is bound
by bytes (8 per int32 element: read once, written once); the three-stage form
reads and writes the output a second time, which a single-pass look-back scan
would avoid.  int32 and int64 are summed in their own type and are exact
(there is no 2^24 limit as in the float32-carried TPU kernel).  float32 is
summed in tree order: four consecutive elements serially per thread, a
shuffle scan over the 32 thread sums of a warp, one over the 8 warp sums,
then the chunk bases — so it agrees with a left-to-right sum only to
rounding.  `exclusive_scan_plain` is the same function as a shifted
``torch.cumsum``; the CPU tests use it and ``chip_smoke.py`` holds the kernel
against it on the card.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from unitysimpleraytracing_tpu_torch.utils import kernel_build

KERNEL_NAME = "scan"
CHUNK = 1024  # elements per thread block
_DTYPE_CODES = {torch.int32: 0, torch.int64: 1, torch.float32: 2}


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
    """The kernels' C entry points, built by nvcc on first use."""
    lib = kernel_build.load_kernel_library(KERNEL_NAME)
    chunks, add = lib.scan_chunks_launch, lib.scan_add_bases_launch
    if chunks.argtypes is None:
        chunks.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        chunks.restype = ctypes.c_int
        add.argtypes = [ctypes.c_void_p] * 2 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        add.restype = ctypes.c_int
    return chunks, add


def _scan_on_card(x: torch.Tensor, fns, stream: int) -> torch.Tensor:
    """Scan chunks, scan the chunk totals (recursively), add the bases."""
    chunks, add = fns
    n = x.shape[0]
    code = _DTYPE_CODES[x.dtype]
    nchunks = -(-n // CHUNK)
    out = torch.empty_like(x)
    totals = torch.empty((nchunks,), dtype=x.dtype, device=x.device) if nchunks > 1 else None
    err = chunks(x.data_ptr(), out.data_ptr(),
                 None if totals is None else totals.data_ptr(), n, code, stream)
    if err != 0:
        raise RuntimeError(f"scan kernel launch failed: CUDA error {err}")
    exclusive_scan.device_launches += 1
    if totals is not None:
        bases = _scan_on_card(totals, fns, stream)
        err = add(out.data_ptr(), bases.data_ptr(), n, code, stream)
        if err != 0:
            raise RuntimeError(f"scan kernel launch failed: CUDA error {err}")
        exclusive_scan.device_launches += 1
    return out


@torch.no_grad()
def exclusive_scan(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum of a 1-D tensor (``out[i] = sum(x[:i])``), int32,
    int64 or float32, returned in the input's dtype.

    On a CUDA tensor this launches the hand-written kernels on the current
    stream without synchronising, or raises; it never gives way to the plain
    version.  On a CPU tensor it runs `exclusive_scan_plain`.
    ``exclusive_scan.launches`` counts the calls that went to the kernels and
    ``exclusive_scan.device_launches`` the kernel launches they made (1 for up
    to 1024 elements, 3 up to 2^20, 5 up to 2^30).
    """
    _check_input(x)
    if x.device.type == "cpu":
        return exclusive_scan_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    fns = _load_kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        out = _scan_on_card(x, fns, stream)
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
