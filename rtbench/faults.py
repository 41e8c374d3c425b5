"""Faults planted under the timed path, to show that ``correct`` catches
them: the program wrapped so that its entry points

- ``stale``: return their first answer again on every later call (a step
  that leaves its state unchanged);
- ``half``: leave out the second half of the rays (half the image black,
  half the hits missed);
- ``altered``: alter every answer where it is produced (each colour one
  8-bit step brighter; each t longer by a thousandth);
- ``uv_zero``, ``uv_swap``: the nearest-hit traversal writes u = v = 0, or
  swaps u and v, and the frame is shaded from those hits.
"""
from __future__ import annotations

import importlib

import torch

FAULTS = ("stale", "half", "altered", "uv_zero", "uv_swap")
MISS_T = 3.4028234663852886e38


class Faulty:
    def __init__(self, program, fault: str):
        if fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
        self._program, self._fault, self._first = program, fault, None

    def __getattr__(self, name):
        return getattr(self._program, name)

    def render_frame(self, *args, **kwargs):
        if self._fault.startswith("uv_"):
            render = importlib.import_module(self._program.__name__ + ".pipeline.render")
            trace = render.camera_trace
            render.camera_trace = lambda *a, **k: self._hits(trace(*a, **k))
            try:
                return self._program.render_frame(*args, **kwargs)
            finally:
                render.camera_trace = trace
        return self._frame(self._program.render_frame(*args, **kwargs))

    def render_hits(self, *args, **kwargs):
        return self._hits(self._program.render_hits(*args, **kwargs))

    def make_animated_renderer(self, *args, **kwargs):
        frame = self._program.make_animated_renderer(*args, **kwargs)
        return lambda positions: self._hits(frame(positions))

    def _frame(self, out):
        if self._fault == "stale":
            self._first = out if self._first is None else self._first
            return self._first
        out = out.clone()
        if self._fault == "half":
            out[out.shape[0] // 2:, :, :3] = 0.0
        else:
            out[..., :3] += 1.0 / 255.0
        return out

    def _hits(self, hits):
        if self._fault == "uv_zero":
            return hits.replace(u=torch.zeros_like(hits.u), v=torch.zeros_like(hits.v))
        if self._fault == "uv_swap":
            return hits.replace(u=hits.v, v=hits.u)
        if self._fault == "stale":
            self._first = hits if self._first is None else self._first
            return self._first
        t, tri = hits.t.clone(), hits.tri.clone()
        if self._fault == "half":
            r = t.shape[0] // 2
            t[r:], tri[r:] = MISS_T, 0
        else:
            t = t * 1.001
        return hits.replace(t=t, tri=tri)
