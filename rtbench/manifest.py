"""``BENCHMARK.json`` and the files it names, found by name: a
configuration at its ``file``, a traffic mix at ``rtbench/traffic/<traffic>.json``,
a per-layer metric's reader at ``rtbench/metrics/<name>.py``."""
from __future__ import annotations

import json
import os

from rtbench import plugins

ROOT = plugins.ROOT
HERE = "rtbench"


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Manifest:
    def __init__(self, root: str = ROOT):
        self.root = root
        self.data = _read_json(os.path.join(root, "BENCHMARK.json"))

    def cell(self, name: str) -> dict:
        """The workload entry, with its configuration and traffic loaded."""
        for w in self.data["workloads"]:
            if w["name"] == name:
                break
        else:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        cfg = next(c for c in self.data["configs"] if c["name"] == w["config"])
        return {
            **w,
            "config_data": _read_json(os.path.join(self.root, cfg["file"])),
            "traffic_data": _read_json(
                os.path.join(self.root, HERE, "traffic", w["traffic"] + ".json")),
        }

    def end_to_end(self, cell: str) -> list[dict]:
        return [m for m in self.data["end_to_end"] if _applies(m, cell)]

    def per_layer(self, cell: str) -> list[dict]:
        return [m for m in self.data["per_layer"] if _applies(m, cell)]

    def reader(self, metric: str):
        """The ``read(ctx)`` function of ``rtbench/metrics/<metric>.py``."""
        return plugins.load("metrics", metric, self.root).read
