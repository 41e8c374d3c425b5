"""Failure detection / recovery helpers (SURVEY §5: the reference has none).

Counterpart of ``unitysimpleraytracing_tpu/utils/resilience.py``, same names
and contract:

- :func:`device_healthcheck` — a bounded-latency end-to-end device probe
  that distinguishes "device answering" from "device wedged",
- :func:`with_retry` — re-run a step across transient runtime errors with
  exponential backoff (the host-side half of elastic recovery; state lives
  in checkpoints — see io/checkpoint for the persistence half),
- :func:`is_transient` — which errors those are: the JAX runtime's five
  status markers and the CUDA / ``torch.distributed`` wording of the same
  five states.  A sticky CUDA error (an illegal address, a failed launch, a
  device-side trap or assert) leaves the process's CUDA context unusable,
  so no retry in this process can succeed: it is never transient.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, TypeVar

import torch

from unitysimpleraytracing_tpu_torch.utils.device import resolve_device

T = TypeVar("T")

_TRANSIENT_MARKERS = (
    # DEADLINE_EXCEEDED: a collective that timed out (NCCL's watchdog, gloo's
    # transport).
    "DEADLINE_EXCEEDED",
    "Watchdog caught collective operation timeout",
    "Timed out waiting",
    # UNAVAILABLE: the card is held by another process or in exclusive mode;
    # NCCL's peer or network went away.
    "UNAVAILABLE",
    "CUDA-capable device(s) is/are busy or unavailable",
    "ncclRemoteError",
    # ABORTED: NCCL aborted the communicator (after a peer's failure).
    "ABORTED",
    "NCCL communicator was aborted",
    # INTERNAL: NCCL's own internal error.
    "INTERNAL",
    "ncclInternalError",
    # RESOURCE_EXHAUSTED: device memory ran out (torch.OutOfMemoryError).
    "RESOURCE_EXHAUSTED",
    "CUDA out of memory",
)

# Errors after which the CUDA context is dead for the rest of the process
# (cudaErrorIllegalAddress, cudaErrorLaunchFailure, which a kernel's
# __trap() stack-overflow guard raises, cudaErrorIllegalInstruction,
# cudaErrorMisalignedAddress, cudaErrorHardwareStackError, cudaErrorAssert,
# cudaErrorLaunchTimeout), and PyTorch's own failed internal checks (a bug):
# retrying cannot help, whatever else the message says.
_STICKY_MARKERS = (
    "illegal memory access",
    "unspecified launch failure",
    "illegal instruction",
    "misaligned address",
    "hardware stack error",
    "device-side assert triggered",
    "the launch timed out and was terminated",
    "INTERNAL ASSERT FAILED",
)


def is_transient(err: Exception) -> bool:
    """Heuristic: does this runtime error look retryable?"""
    s = str(err)
    if any(m in s for m in _STICKY_MARKERS):
        return False
    if isinstance(err, torch.OutOfMemoryError):
        return True
    return any(m in s for m in _TRANSIENT_MARKERS)


def device_healthcheck(timeout_s: float = 30.0, device=None) -> bool:
    """True if ``device`` completes a trivial computation within
    ``timeout_s``: (8, 128) ones, times 2, summed, equal to 2048.

    ``device=None`` is the card and raises without one, like every entry
    point of the port.  The probe runs on a daemon thread that synchronises
    the device itself, so a wedged card cannot hang the caller past the
    timeout; a probe that fails or times out gives False."""
    dev = resolve_device(device)
    result: queue.Queue = queue.Queue(maxsize=1)

    def probe() -> None:
        try:
            x = torch.ones((8, 128), dtype=torch.float32, device=dev)
            y = (x * 2.0).sum()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            result.put(float(y) == 2048.0)
        except Exception:  # noqa: BLE001 - any failure of the probe is "unhealthy"
            result.put(False)

    threading.Thread(target=probe, name="device-healthcheck", daemon=True).start()
    try:
        return bool(result.get(timeout=timeout_s))
    except queue.Empty:
        return False


def with_retry(
    fn: Callable[[], T],
    retries: int = 2,
    backoff_s: float = 2.0,
    on_retry: Callable[[int, Exception], None] | None = None,
) -> T:
    """Run ``fn``; on a transient runtime error, back off and retry.

    Non-transient exceptions propagate immediately.  Raises the last error
    after ``retries`` failed retries."""
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - filtered by is_transient
            if attempt >= retries or not is_transient(e):
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            time.sleep(backoff_s * (2**attempt))
            attempt += 1
