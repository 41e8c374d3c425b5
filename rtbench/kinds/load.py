"""Scene load to first frame: each step takes the next of a pool of ``pool``
host meshes (seeds pool·seed + k) and the configuration's texture, ingests
them, builds the tree (``builder``) and renders one frame from the fixed
camera."""
from __future__ import annotations

import numpy as np

from rtbench.judge import Pixels
from rtbench.seeds import seed_of
from rtbench.steps import Base


class Kind(Pixels, Base):
    def setup(self):
        n = self.traffic["pool"]
        self.pool = [self.scene_arrays(n * seed_of(self.seed) + k) for k in range(n)]
        self.meshes = [self.make_mesh(a) for a in self.pool]
        self.triangles = self.pool[0][0].shape[0]
        self.texture_image = self.texture_array()
        self.bg = np.asarray(self.config["background"], np.float32)

    def step(self, i: int):
        mesh = self.meshes[i % len(self.meshes)]
        with self.spans("core.mesh"):
            scene = self.rt.build_scene(mesh, device=self.device)
        with self.spans("pipeline.build"):
            bvh = self.rt.build_bvh(scene, builder=self.traffic.get("builder"))
        with self.spans("pipeline.render"):
            tex = self.upload_texture(self.texture_image)
            cam = self.make_camera(self.camera())
            return self.rt.render_frame(scene, bvh, cam, tex, self.bg, shadows=self.shadows)

    def reference_inputs(self, i: int):
        return self.pool[i % len(self.pool)], self.camera()
