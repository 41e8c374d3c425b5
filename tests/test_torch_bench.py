"""The port's bench entry point (``benchmarks/bench.py``) against the repo's
headline benchmark: its keys cover ``BENCH_r05.json``'s, its scenes are
``bench.py``'s, it names no TPU constant, and it measures on the card only."""
import json
import os

import pytest
import torch

import bench as jax_bench  # imports JAX only inside its main()
from unitysimpleraytracing_tpu_torch.benchmarks import bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _r05_extra():
    with open(os.path.join(ROOT, "BENCH_r05.json")) as f:
        return json.load(f)["parsed"]["extra"]


def test_every_r05_key_is_emitted_or_named_tpu_only():
    extra = _r05_extra()
    emitted = set(bench.EXTRA_KEYS) | set(bench.ASSET_KEYS)
    uncovered = sorted(set(extra) - emitted - set(bench.TPU_ONLY_KEYS))
    assert not uncovered, uncovered
    assert not emitted & set(bench.TPU_ONLY_KEYS)
    # Every TPU-only key is one bench.py writes, with a reason.
    assert set(bench.TPU_ONLY_KEYS) <= set(extra)
    assert all(isinstance(r, str) and len(r) > 10 for r in bench.TPU_ONLY_KEYS.values())
    assert len(set(bench.EXTRA_KEYS)) == len(bench.EXTRA_KEYS)


@pytest.mark.parametrize("name", ["WIDTH", "HEIGHT", "TERRAIN_RES", "SPONZA_RES", "BIG_RES",
                                  "SORT_N"])
def test_scene_constants_are_bench_py_s(name):
    assert getattr(bench, name) == getattr(jax_bench, name)


def test_bench_names_no_tpu_constant_and_no_baseline():
    import inspect

    src = inspect.getsource(bench)
    code = src[src.index("def main("):]
    for banned in ("STEP_FLOOR_NS", "RECORD4_FLOOR_NS", "SORT_GKEYS_CEILING", "baseline.json",
                   "except", "try:"):
        assert banned not in code, banned
    assert '"vs_baseline": None' in code
    # The sort ceiling is the card's: 64 bytes a key (4 passes of key and
    # value read and written) at 3.35 TB/s.
    assert bench.sort_gkeys_ceiling(bench.SORT_N) == pytest.approx(3.35e12 / 64 / 1e9)


def test_asset_rows_are_left_out_without_their_files(tmp_path):
    assert bench.asset(None, bench.DEMO_OBJ) is None
    assert bench.asset(str(tmp_path), bench.DEMO_OBJ) is None
    (tmp_path / bench.HEAD_OBJ).write_text("v 0 0 0\n")
    assert bench.asset(str(tmp_path), bench.HEAD_OBJ) == str(tmp_path / bench.HEAD_OBJ)


def test_bench_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the bench runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main([])
