"""A deforming mesh seen from the fixed camera: each step animates every
corner (`rtbench.steps.deform`, at phase φ0 + ``phase_step``·i, φ0 from the
seed) and either rebuilds the tree (``tree: rebuild``, ``builder``) and
traces, or runs the program's animated frame over a tree built once
(``tree: refit``).  The output is the primary hits."""
from __future__ import annotations

import math

import torch

from rtbench.judge import Hits
from rtbench.seeds import STREAM_PHASE, rng
from rtbench.steps import Base, deform


class Kind(Hits, Base):
    def passes(self):
        return [(self.width * self.height, False)]

    def setup(self):
        self.arrays = self.scene_arrays(self.seed)
        n = self.triangles = self.arrays[0].shape[0]
        self.scene = self.rt.build_scene(self.make_mesh(self.arrays), device=self.device)
        base = torch.zeros((self.scene.capacity, 3, 3), dtype=torch.float32)
        base[:n] = torch.from_numpy(self.arrays[0])
        self.base = base.to(self.device)
        self.phase0 = float(rng(self.seed, STREAM_PHASE).uniform(0, 2 * math.pi))
        self.cam_ = self.make_camera(self.camera())
        self.anim = None
        if self.traffic["tree"] == "refit":
            bvh = self.rt.build_bvh(self.scene, builder=self.traffic.get("builder"))
            self.anim = self.rt.make_animated_renderer(self.scene, bvh, self.cam_)
        elif self.traffic["tree"] != "rebuild":
            raise ValueError(f"unknown tree policy {self.traffic['tree']!r}")

    def positions(self, i: int):
        t = self.traffic
        return deform(self.base, t["amplitude"], t["frequency"],
                      self.phase0 + t["phase_step"] * i)

    def step(self, i: int):
        with self.spans("harness.deform"):
            pos = self.positions(i)
        if self.anim is not None:
            with self.spans("pipeline.render"):
                return self.anim(pos)
        with self.spans("pipeline.deform"):
            scene = self.rt.deform_scene(self.scene, pos)
        with self.spans("pipeline.build"):
            bvh = self.rt.build_bvh(scene, builder=self.traffic.get("builder"))
        with self.spans("pipeline.render"):
            return self.rt.render_hits(scene, bvh, self.cam_)

    def reference_inputs(self, i: int):
        corners = self.positions(i)[: self.triangles].cpu().numpy()
        return (corners, self.arrays[1], self.arrays[2]), self.camera()

    def close(self):
        self.scene = self.anim = self.cam_ = None
