"""A configuration, a traffic mix, a step kind, a scene generator, an
end-to-end number and a per-layer metric added as new files (and entries)
are found by name and run, with no edit to any file already there."""
from __future__ import annotations

import json
import os
import shutil
from types import SimpleNamespace

import torch
from conftest import ROOT, tiny_config

# A new step kind: primary hits from the fixed camera over a tree built
# once, reporting a rate besides the kind's usual numbers.
STILL = '''
from rtbench.judge import Hits
from rtbench.steps import Base


class Kind(Hits, Base):
    def setup(self):
        self.arrays = self.scene_arrays(self.seed)
        self.triangles = self.arrays[0].shape[0]
        self.scene = self.rt.build_scene(self.make_mesh(self.arrays), device=self.device)
        self.bvh = self.rt.build_bvh(self.scene)
        self.cam_ = self.make_camera(self.camera())

    def step(self, i):
        with self.spans("pipeline.render"):
            return self.rt.render_hits(self.scene, self.bvh, self.cam_)

    def reference_inputs(self, i):
        return self.arrays, self.camera()

    def end_to_end(self, window_s, latencies, setup_s):
        out = super().end_to_end(window_s, latencies, setup_s)
        out["rays_per_s"] = self.width * self.height * len(latencies) / window_s
        return out
'''

# A new scene generator: a tilted square of two triangles, uv over [0, 1].
SQUARE = '''
import numpy as np


def make(params, seed):
    s = params["size"] / 2
    a, b, c, d = [(-s, 0.0, -s), (s, 0.0, -s), (s, params["tilt"], s), (-s, params["tilt"], s)]
    pos = np.array([[a, b, c], [a, c, d]], np.float32)
    uv = (pos[..., [0, 2]] / (2 * s) + 0.5).astype(np.float32)
    n = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    return pos, uv, np.repeat(n[:, None], 3, axis=1).astype(np.float32)
'''


def test_new_files_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "rtbench"), root / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    cfg = json.loads((root / "rtbench/configs/terrain65k.json").read_text())
    cfg["scene"] = {"generator": "square", "size": 40.0, "tilt": 5.0}
    (root / "rtbench/configs/square2.json").write_text(json.dumps(cfg))
    (root / "rtbench/scenes/square.py").write_text(SQUARE)
    (root / "rtbench/kinds/still.py").write_text(STILL)
    tr = json.loads((root / "rtbench/traffic/deform_rebuild.json").read_text())
    tr = {k: tr[k] for k in ("unit", "warmup_steps", "trace_steps", "check", "limits")}
    (root / "rtbench/traffic/still.json").write_text(json.dumps({"kind": "still", **tr}))
    (root / "rtbench/metrics/steps_in_slice.py").write_text(
        "def read(ctx):\n    return ctx.trace.steps\n")

    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "square2", "source": "a test", "why": "a test",
                         "file": "rtbench/configs/square2.json", "reduced": []})
    b["workloads"].append({"name": "square2.still", "config": "square2",
                           "traffic": "still", "chips": 1, "why": "a test"})
    for m in b["end_to_end"]:
        if m["name"] in ("frame_ms", "frame_ms_p95"):
            m["workloads"].append("square2.still")
    b["end_to_end"].append({"name": "rays_per_s", "unit": "rays/s", "better": "higher",
                            "bound": 0.05, "source": "host_clock",
                            "workloads": ["square2.still"]})
    b["per_layer"].append({"name": "steps_in_slice", "unit": "steps", "better": "higher",
                           "source": "device_trace", "layer": "device", "moves": "frame_ms",
                           "workloads": ["square2.still"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    from rtbench import run
    from rtbench.manifest import Manifest

    m = Manifest(str(root))
    cell = m.cell("square2.still")
    assert cell["config_data"]["scene"]["generator"] == "square"
    assert [x["name"] for x in m.per_layer("square2.still")] == ["steps_in_slice"]
    assert m.reader("steps_in_slice")(SimpleNamespace(trace=SimpleNamespace(steps=7))) == 7
    assert "steps_in_slice" not in [x["name"] for x in m.per_layer("terrain260k.orbit")]

    torch.set_num_threads(2)
    r = run.run_cell(m, "square2.still", 11, 0.2, False, device="cpu",
                     config=tiny_config(cell))
    assert r["correct"] and r["sampled"]["wrong"] == 0, r["checks"]
    assert set(r["metrics"]) == {"frame_ms", "frame_ms_p95", "setup_s", "rays_per_s"}
    assert r["metrics"]["rays_per_s"]["value"] > 0
    assert list(r["checks"]) == ["bad_ray_share"]
