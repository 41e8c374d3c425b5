"""What every step kind shares.  A traffic mix is a JSON file of parameters
(``rtbench/traffic/<name>.json``); its ``kind`` names the file of the loop
that runs it (``rtbench/kinds/<kind>.py``, class ``Kind``), and the
configuration (``rtbench/configs/<name>.json``) gives the scene (made by
``rtbench/scenes/<generator>.py``), the texture (``rtbench/textures/
<generator>.py``), camera, image and colours.

Every step is one closed-loop request: one frame presented, or one scene
loaded to its first frame.  Each kind

- makes its inputs from the run's seed;
- calls the program only through its public entry points, with spans around
  each call;
- holds no reference to an earlier step's scene or tree;
- hands the judge the step's output and, on request, the inputs the
  reference needs to work the answer out again (``reference_inputs``), in
  the form of one of `rtbench.judge`'s outputs, which it takes as a base.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from rtbench import plugins, stats


def orbit_eye(eye, angle: float):
    """``eye`` turned by ``angle`` radians about the y axis through the
    origin (same distance from the axis, same height)."""
    x, y, z = (float(c) for c in eye)
    c, s = math.cos(angle), math.sin(angle)
    return (c * x + s * z, y, -s * x + c * z)


def deform(base: torch.Tensor, amplitude: float, frequency: float, phase: float):
    """The animated corners (T, 3, 3): ``y += amplitude·sin(frequency·x +
    phase)`` on every corner of ``base``."""
    pos = base.clone()
    pos[..., 1] += amplitude * torch.sin(base[..., 0] * frequency + phase)
    return pos


def make(config: dict, traffic: dict, seed: int, device, program, spans,
         root: str = plugins.ROOT, rank: int = 0, world: int = 1):
    """The traffic's kind, loaded by name, set to run."""
    cls = plugins.load("kinds", traffic["kind"], root).Kind
    return cls(config, traffic, seed, device, program, spans, root, rank=rank, world=world)


class Base:
    """The configuration, the traffic's parameters, the program, its device
    and the spans, and what most kinds do with them.

    On a cell of n > 1 cards each of n rank processes holds a kind: ``rank``
    (0 to n - 1) and ``world`` (n); 0 and 1 on one card.  Every rank gets the
    same configuration, traffic, seed and step indices, and ``device``
    ``"cuda"`` is the rank's own card.  Rank 0's step returns what the judge
    reads; the other ranks' outputs are dropped.  ``close`` makes no
    collective call: the other ranks close while rank 0 judges."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, program, spans,
                 root: str = plugins.ROOT, rank: int = 0, world: int = 1):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.rank, self.world = rank, world
        self.device, self.rt, self.spans, self.root = device, program, spans, root
        self.width, self.height = config["width"], config["height"]
        self.unit = traffic["unit"]

    def scene_arrays(self, seed: int):
        """``(positions, uvs, normals)`` of the configuration's scene."""
        s = self.config["scene"]
        return plugins.load("scenes", s["generator"], self.root).make(s, seed)

    def texture_array(self) -> np.ndarray:
        """The configuration's texture, (H, W, 4) float32, row 0 at v = 0."""
        t = self.config["texture"]
        return plugins.load("textures", t["generator"], self.root).make(t, self.seed)

    def upload_texture(self, image: np.ndarray):
        # The program takes images in file order (row 0 at the top).
        return self.rt.texture_from_array(np.ascontiguousarray(image[::-1]), device=self.device)

    def camera(self, eye=None):
        cam = self.config["camera"]
        return dict(eye=tuple(cam["eye"]) if eye is None else eye,
                    target=tuple(cam["target"]), fov_deg=cam["fov_deg"],
                    near=cam["near"], width=self.width, height=self.height)

    def make_camera(self, cam: dict):
        return self.rt.make_camera(cam["eye"], cam["target"], cam["width"], cam["height"],
                                   fov_deg=cam["fov_deg"], near=cam["near"],
                                   device=self.device)

    def make_mesh(self, arrays):
        pos, uv, nrm = arrays
        return self.rt.MeshData(positions=pos, uvs=uv, normals=nrm)

    @property
    def shadows(self) -> bool:
        return bool(self.traffic.get("shadows", False))

    def passes(self):
        """(rays, shadow) of each traversal one step needs."""
        rays = self.width * self.height
        return [(rays, False)] + ([(rays, True)] if self.shadows else [])

    def end_to_end(self, window_s: float, latencies: list, setup_s: float) -> dict:
        """Every end-to-end number this kind's runs can report, by name."""
        return {f"{self.unit}_ms": stats.window_ms(window_s, len(latencies)),
                f"{self.unit}_ms_p95": stats.percentile(latencies, 95) * 1e3,
                "setup_s": setup_s}

    def close(self):
        """Drop the program's state before the reference runs."""
