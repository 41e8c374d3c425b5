"""Shared helpers of the benchmark's own tests (CPU unless marked ``gpu``)."""
from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {"res": 24, "width": 64, "height": 64}


def tiny_config(cell: dict) -> dict:
    """The cell's configuration at a size the CPU holds in seconds."""
    cfg = dict(cell["config_data"])
    cfg["scene"] = dict(cfg["scene"], res=TINY["res"])
    cfg["width"], cfg["height"] = TINY["width"], TINY["height"]
    return cfg


# A cell whose files stay in the benchmark while BENCHMARK.json leaves it out
# (its runs spread wider than a bound can hold: PERF.md, section 7), with the
# metrics it reported. The tests keep its mix, its kind's path and its reader
# running.
LATER = {
    "workload": {"name": "terrain65k.deform_rebuild", "config": "terrain65k",
                 "traffic": "deform_rebuild", "chips": 1, "why": "kept for later"},
    "metrics": ("frame_ms", "frame_ms_p95", "launches_per_frame", "device_idle_share.frame",
                "k1_roofline"),
    "reader": {"name": "build_ms.rebuild", "unit": "ms", "better": "lower",
               "source": "program_span", "layer": "pipeline.build", "moves": "frame_ms"},
}


@pytest.fixture
def manifest():
    """BENCHMARK.json as committed, with the `LATER` cell added in memory."""
    from rtbench.manifest import Manifest

    m = Manifest(ROOT)
    cell = LATER["workload"]["name"]
    m.data["workloads"].append(dict(LATER["workload"]))
    for group in ("end_to_end", "per_layer"):
        for metric in m.data[group]:
            if metric["name"] in LATER["metrics"]:
                metric["workloads"] = metric["workloads"] + [cell]
    m.data["per_layer"].append({**LATER["reader"], "workloads": [cell]})
    return m
