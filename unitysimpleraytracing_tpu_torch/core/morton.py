"""Vectorized 30-bit Morton encoding.

Bit-identical to the reference's scalar host loop
(``Assets/_Scripts/MeshBufferContainer.cs:32-50``: ``ExpandBits``/``Morton3D``).
Codes are carried as int64: every intermediate is masked to 32 bits, so the
values equal the uint32 arithmetic of the JAX package.
"""
from __future__ import annotations

import torch

from unitysimpleraytracing_tpu_torch import constants as C


def expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of each element out to every 3rd bit.

    Magic-constant sequence identical to MeshBufferContainer.cs:32-39; each
    mask is below 2^32, so it also applies the 32-bit wrap of the multiply.
    """
    v = v.to(torch.int64)
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3d(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Encode unit-cube coordinates to 30-bit Morton codes (x-major interleave).

    Mirrors MeshBufferContainer.cs:41-50: scale by 1024, clamp to [0, 1023],
    truncate, interleave as ``xx*4 + yy*2 + zz``.
    """
    def quantize(f):
        f = torch.clamp(f * C.MORTON_GRID, 0.0, C.MORTON_GRID - 1.0)
        return f.to(torch.int64)

    xx = expand_bits(quantize(x))
    yy = expand_bits(quantize(y))
    zz = expand_bits(quantize(z))
    return xx * 4 + yy * 2 + zz


def morton_from_points(p: torch.Tensor) -> torch.Tensor:
    """Encode an (N, 3) array of unit-cube points."""
    return morton3d(p[:, 0], p[:, 1], p[:, 2])
