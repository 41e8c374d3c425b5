"""Key/value sort — the build's ordering primitive.

The reference implements a 4-pass, 8-bit-digit LSD radix sort as three HLSL
kernels driven from C# (``Assets/_Scripts/ComputeBufferSorter.cs:100-126``).
The JAX package's build default (``lex2``) equals the stable pair sort
whenever the carried values are distinct, which the build guarantees
(``tri_index`` is iota on real rows; padding rows all carry the same key and
value).  The port therefore has one engine: a stable sort of the int64 keys
with the values gathered along.  The radix-sort decomposition and its hand
kernels are a later slice (ROADMAP queue 1 item 11, queue 2 K3-K5).
"""
from __future__ import annotations

import torch


def sort_key_val(
    keys: torch.Tensor, values: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable ascending sort of ``keys`` with ``values`` carried along."""
    sorted_keys, perm = torch.sort(keys, stable=True)
    return sorted_keys, values[perm]
