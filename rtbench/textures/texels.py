"""A texture of ``texels`` x ``texels`` colours drawn from the seed, each
channel uniform in [``low``, ``high``]: every point of the surface samples
a different bilinear blend, so shading depends on where in its triangle a
ray hits."""
from __future__ import annotations

import numpy as np

from rtbench.seeds import STREAM_TEXTURE, rng


def make(params: dict, seed: int) -> np.ndarray:
    """(H, W, 4) float32, row 0 at v = 0, alpha 1."""
    n = params["texels"]
    img = np.ones((n, n, 4), np.float32)
    img[..., :3] = rng(seed, STREAM_TEXTURE).uniform(params["low"], params["high"], (n, n, 3))
    return img
