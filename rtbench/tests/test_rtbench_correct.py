"""``correct`` at a size the CPU holds: a sound run passes; the control (the
reference in bfloat16 in the program's place) and each fault planted under
the timed path (`rtbench.faults`) fail, in every cell."""
from __future__ import annotations

import pytest
import torch
from conftest import tiny_config

import unitysimpleraytracing_tpu_torch as program
from rtbench import faults, run
from rtbench.judge import Reservoir

CELLS = ("terrain260k.orbit", "terrain65k.deform_rebuild", "terrain260k.load",
         "terrain65k.deform_refit")
SEED = 2**31 + 977


def _run(manifest, cell, prog=program, control=None, trace=False):
    torch.set_num_threads(2)
    return run.run_cell(manifest, cell, SEED, 0.3, trace, device="cpu", program=prog,
                        config=tiny_config(manifest.cell(cell)), control=control)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(manifest, cell):
    r = _run(manifest, cell)
    assert r["correct"] and r["sampled"]["wrong"] == 0, r["checks"]
    assert r["sampled"]["outputs"] >= 1
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {m["name"] for m in manifest.end_to_end(cell)}


@pytest.mark.parametrize("cell", CELLS)
def test_the_bfloat16_control_fails(manifest, cell):
    r = _run(manifest, cell, control=torch.bfloat16)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_fails(manifest, cell, fault):
    r = _run(manifest, cell, prog=faults.Faulty(program, fault))
    assert not r["correct"], r["checks"]


def test_a_traced_run_judges_the_same(manifest):
    r = _run(manifest, "terrain65k.deform_rebuild", trace=True)
    assert r["correct"] and "build_ms.rebuild" in r["metrics"]
    assert r["device"]["window_s"] > 0 and "breakdown" in r


def test_the_reservoir_keeps_a_uniform_sample():
    counts = [0] * 10
    for seed in range(2000):
        res = Reservoir(2, seed)
        for i in range(10):
            res.offer(i, None)
        for i, _ in res.kept:
            counts[i] += 1
    assert min(counts) > 300 and max(counts) < 500
