"""Sorted-key uniquification ("DistributeKeys").

The Karras topology requires strictly distinct keys (BVH.compute:29
"we guarantee that x_code != y_code").  The reference guarantees this with a
GPU→CPU→GPU round-trip (MeshBufferContainer.cs:154-169); here the same rewrite
is one device expression: ``new[0] = 0; new[i] = cumsum(max(sorted[i] -
sorted[i-1], 1))``.  The result is strictly increasing, preserves the relative
spacing of distinct codes, and stays within 31 bits for 30-bit inputs.
"""
from __future__ import annotations

import torch


def distribute_keys(sorted_keys: torch.Tensor, count: int) -> torch.Tensor:
    """Rewrite the first ``count`` sorted keys to be strictly increasing.

    Keys are int64 holding uint32 values; the running sum is masked to 32
    bits so it equals the uint32 cumsum of the JAX package.  Padding beyond
    ``count`` is left untouched (it stays 0xFFFFFFFF).
    """
    cap = sorted_keys.shape[0]
    idx = torch.arange(cap, device=sorted_keys.device)
    prev = torch.cat([sorted_keys[:1], sorted_keys[:-1]])
    steps = torch.clamp(sorted_keys - prev, min=1)
    steps = torch.where((idx >= 1) & (idx < count), steps, 0)
    new = torch.cumsum(steps, dim=0) & 0xFFFFFFFF  # new[0] == 0 by masking
    return torch.where(idx < count, new, sorted_keys)
