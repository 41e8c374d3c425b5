"""Device resolution for the entry points that create tensors.

The port runs on the card by default.  ``device=None`` means
``torch.device("cuda")``; without a CUDA device that RAISES — an entry point
never carries on on the CPU unless the caller asked for ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to run "
            "the port on the CPU"
        )
    return device
