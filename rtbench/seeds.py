"""Seeds: any whole number the command takes, as numpy generators, one
independent stream per use."""
from __future__ import annotations

import numpy as np

# Streams of the seed: one independent generator per use.
STREAM_CAMERA, STREAM_PHASE, STREAM_RESERVOIR, STREAM_PIXELS, STREAM_TEXTURE = 2, 3, 4, 5, 6


def seed_of(seed: int) -> int:
    """Any whole number (negative, or wider than 64 bits) as a numpy seed."""
    return int(seed) % (1 << 64)


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed_of(seed), stream]))
