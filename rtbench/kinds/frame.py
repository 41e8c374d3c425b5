"""A static scene, built once in set-up, rendered frame by frame
(``render_frame``) from a camera turned ``deg_per_step`` degrees a frame
about the y axis, from a start angle drawn from the seed."""
from __future__ import annotations

import math

import numpy as np

from rtbench.judge import Pixels
from rtbench.seeds import STREAM_CAMERA, rng
from rtbench.steps import Base, orbit_eye


class Kind(Pixels, Base):
    def setup(self):
        self.arrays = self.scene_arrays(self.seed)
        self.triangles = self.arrays[0].shape[0]
        self.scene = self.rt.build_scene(self.make_mesh(self.arrays), device=self.device)
        self.bvh = self.rt.build_bvh(self.scene, builder=self.traffic.get("builder"))
        self.texture_image = self.texture_array()
        self.tex = self.upload_texture(self.texture_image)
        self.bg = np.asarray(self.config["background"], np.float32)
        self.angle0 = float(rng(self.seed, STREAM_CAMERA).uniform(0, 2 * math.pi))

    def cam(self, i: int) -> dict:
        step = math.radians(self.traffic["deg_per_step"])
        return self.camera(orbit_eye(self.config["camera"]["eye"], self.angle0 + i * step))

    def step(self, i: int):
        with self.spans("pipeline.render"):
            cam = self.make_camera(self.cam(i))
            return self.rt.render_frame(self.scene, self.bvh, cam, self.tex, self.bg,
                                        shadows=self.shadows)

    def reference_inputs(self, i: int):
        return self.arrays, self.cam(i)

    def close(self):
        self.scene = self.bvh = self.tex = None
