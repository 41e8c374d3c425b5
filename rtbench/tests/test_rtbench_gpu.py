"""One cell for two seconds on the card (marked ``gpu``; skips without one)."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
from conftest import ROOT


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
def test_one_cell_on_the_card(card):
    p = subprocess.run(
        [sys.executable, "rtbench/run.py", "--workload", "terrain65k.deform_refit",
         "--seed", "2147483999", "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"frame_ms", "frame_ms_p95", "setup_s"}
    assert p.stderr.strip().splitlines()[-1].startswith("check bad_ray_share")
