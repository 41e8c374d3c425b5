"""BENCHMARK.json against the benchmark's contract, and every file it names."""
from __future__ import annotations

import json
import os
import re

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def load():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_sizes():
    b = load()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(b["paths"]) <= 16 and all(PATH.match(p) for p in b["paths"])
    assert all(not p.startswith("/") and ".." not in p for p in b["paths"])
    assert 1 <= len(b["command"]) <= 32 and all(one_line(w) for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert 1 <= len(b["configs"]) <= 24 and 1 <= len(b["workloads"]) <= 24
    assert 1 <= len(b["end_to_end"]) <= 16 and 1 <= len(b["per_layer"]) <= 128


def test_names_units_and_entries():
    b = load()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in b["paths"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and one_line(w["why"])
    metrics = b["end_to_end"] + b["per_layer"]
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and one_line(m["layer"])
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for group in (b["configs"], b["workloads"], metrics):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_at_most_a_quarter_of_cells_on_four_chips():
    w = load()["workloads"]
    assert sum(x["chips"] == 4 for x in w) <= max(1, len(w) // 4)


def test_every_cell_reports_what_it_must():
    b = load()
    cells = {w["name"] for w in b["workloads"]}
    configs = {c["name"] for c in b["configs"]}
    assert {w["config"] for w in b["workloads"]} == configs

    def reports(m, cell):
        return "workloads" not in m or cell in m["workloads"]

    setup = next(m for m in b["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25 and "workloads" not in setup
    for cell in cells:
        e2e = {m["name"] for m in b["end_to_end"] if reports(m, cell)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(reports(m, cell) for m in b["per_layer"])
    by_name = {m["name"]: m for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in by_name
        assert set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            assert reports(by_name[m["moves"]], cell), (m["name"], cell)
    for m in b["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells


def test_layers_name_one_layer_one_way():
    b = load()
    for m in b["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_named_files_exist(manifest):
    b = load()
    for c in b["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            data = json.load(f)
        assert set(c["reduced"]) <= set(data) and set(c["reduced"]) == set(data["reduced"])
        assert data["source"] and data["assumed"] and data["precision"] == "float32"
    for w in b["workloads"]:
        cell = manifest.cell(w["name"])
        for key in ("kind", "unit", "warmup_steps", "trace_steps", "check", "limits"):
            assert key in cell["traffic_data"], (w["traffic"], key)
    for m in b["per_layer"]:
        assert callable(manifest.reader(m["name"]))
