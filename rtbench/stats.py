"""The benchmark's own arithmetic: rates, percentiles, interval unions, the
card's published peaks and the bytes a traversal needs.  No import of the
program: a change to the program cannot move these."""
from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3, at the full 700 W limit.
PEAK_BYTES_PER_S = 3.35e12

# Bytes of a traversal's inputs and outputs, each read or written once.  A
# primary ray: origin and direction in (6 float32), a hit out (t, tri, u, v:
# 4 x 4 bytes).  A shadow (any-hit) ray toward the fixed light: origin and
# limit in (4 float32), one occlusion flag out (1 byte).  A triangle: 3
# corners x 3 float32.
RAY_BYTES = 24
HIT_BYTES = 16
SHADOW_RAY_BYTES = 16
SHADOW_FLAG_BYTES = 1
TRIANGLE_BYTES = 36


def window_ms(window_s: float, steps: int) -> float:
    """The window's time a completed step, in ms."""
    if steps <= 0:
        raise ValueError("no step completed in the window")
    return window_s / steps * 1e3


def percentile(values, q: float) -> float:
    """The q-th percentile (0..100) of every value, interpolated linearly
    between the two nearest ranks."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union_length(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``(start, end)`` intervals clipped to
    ``[lo, hi]``."""
    total, reach = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, reach), min(e, hi)
        if e > s:
            total += e - s
            reach = e
    return total


def gaps(intervals, lo: float, hi: float):
    """The stretches of ``[lo, hi]`` that no interval covers, as
    ``(start, end)``."""
    out, reach = [], lo
    for s, e in sorted(intervals):
        if s > reach and reach < hi:
            out.append((reach, min(s, hi)))
        reach = max(reach, e)
    if reach < hi:
        out.append((reach, hi))
    return out


def idle_share(intervals, lo: float, hi: float) -> float:
    """1 − (union of device intervals) / (the slice's wall time)."""
    return 1.0 - union_length(intervals, lo, hi) / (hi - lo)


def traversal_bytes(passes, triangles: int) -> int:
    """Bytes one traversal launch per pass needs at least: ``passes`` lists
    ``(rays, shadow)`` per launch; each ray's inputs read once, each hit
    written once, the scene's triangles read once a launch."""
    total = 0
    for rays, shadow in passes:
        per_ray = SHADOW_RAY_BYTES + SHADOW_FLAG_BYTES if shadow else RAY_BYTES + HIT_BYTES
        total += rays * per_ray + triangles * TRIANGLE_BYTES
    return total
