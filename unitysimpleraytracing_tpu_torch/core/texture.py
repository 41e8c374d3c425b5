"""Device texture container + bilinear sampling.

Replicates ``_meshTexture.SampleLevel(linearClampSampler, uv, 0)``
(``Assets/_Shaders/Raytracing/Raytracing.compute:182``): mip level 0, bilinear
filtering, clamp-to-edge addressing, texel centers at (i+0.5)/size, and
Unity's bottom-left UV origin (PNG rows are top-down, so the loader flips).
Sampling is four batched texel gathers + lerps over (R,) UV tensors.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from unitysimpleraytracing_tpu_torch.io.png import read_png
from unitysimpleraytracing_tpu_torch.utils.device import resolve_device


@dataclass(eq=False)
class Texture:
    data: torch.Tensor  # (H, W, 4) f32 in [0,1], row 0 = v=0 (bottom)

    @property
    def height(self) -> int:
        return self.data.shape[0]

    @property
    def width(self) -> int:
        return self.data.shape[1]


def _srgb_to_linear(x: np.ndarray) -> np.ndarray:
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def texture_from_array(img: np.ndarray, srgb: bool = False, device=None) -> Texture:
    """(H, W, C) uint8/float, PNG row order (top-down) → device Texture."""
    device = resolve_device(device)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    img = img[::-1]  # PNG top-down → v-up
    if img.ndim == 2:
        img = img[:, :, None]
    c = img.shape[2]
    if c == 1:
        img = np.repeat(img, 3, axis=2)
        c = 3
    if c == 3:
        img = np.concatenate([img, np.ones_like(img[:, :, :1])], axis=2)
    if srgb:
        img = img.copy()
        img[:, :, :3] = _srgb_to_linear(img[:, :, :3])
    data = np.array(img, dtype=np.float32, order="C")  # fresh copy: the flip left negative strides
    return Texture(data=torch.from_numpy(data).to(device))


def load_texture(path: str, srgb: bool = False, device=None) -> Texture:
    return texture_from_array(read_png(path), srgb=srgb, device=device)


def solid_texture(rgba=(1.0, 1.0, 1.0, 1.0), size: int = 8, device=None) -> Texture:
    device = resolve_device(device)
    img = np.broadcast_to(np.asarray(rgba, np.float32), (size, size, 4)).copy()
    return Texture(data=torch.from_numpy(img).to(device))


def sample_bilinear(tex: Texture, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched bilinear clamp-to-edge sample: (R,) u,v → (R, 4) RGBA."""
    h, w = tex.height, tex.width
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = torch.clamp(x0.to(torch.int64), 0, w - 1)
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
    # Below-edge clamp: with x0 < 0 both texels of the pair clamp to index 0
    # (lerp of equal texels == edge texel); the pair fetched at index 0 is
    # (tex0, tex1), so zero the fraction instead — identical result.
    fx = torch.where(x0 < 0, 0.0, fx)
    fy = torch.where(y0 < 0, 0.0, fy)
    # Above-edge clamp: the +1 neighbours clamp to the last texel.
    x1i = torch.clamp(x0i + 1, max=w - 1)
    y1i = torch.clamp(y0i + 1, max=h - 1)
    # Texels are gathered element by element from the flattened texture, not
    # as rows: every row form (flat[idx], index_select, gather with an
    # expanded index) takes PyTorch's one-block-per-row CUDA path for 16-byte
    # rows — 1.25 ms per 2 M-row gather on an H100 against 0.12 ms this way
    # (chip_smoke.py --profile, phase gather_form_ab).  Same values either way.
    flat = tex.data.reshape(h * w * 4)
    cols = torch.arange(4, device=flat.device)

    def texels(yi, xi):
        return flat[((yi * w + xi) * 4)[:, None] + cols]

    t00, t10 = texels(y0i, x0i), texels(y0i, x1i)
    t01, t11 = texels(y1i, x0i), texels(y1i, x1i)
    fx = fx[:, None]
    fy = fy[:, None]
    top = t00 * (1 - fx) + t10 * fx
    bot = t01 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy
