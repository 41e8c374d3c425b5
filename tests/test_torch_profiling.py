"""``utils/profiling`` of the PyTorch port on ``device="cpu"``: the timers on
the host clock, `Profiler`, `OpStats`, and the byte models.  The byte models
that do not depend on the machine (`sort_bytes`, `build_bytes`) equal the JAX
package's; the traversal model and the roofline defaults are the port's own
(per ray, against an H100's published peaks) and are held to their
definitions.  Times are only required to be positive and ordered: a CPU time
is no device metric."""
import json
import os
import time

import numpy as np
import pytest
import torch

import unitysimpleraytracing_tpu_torch as pt
from unitysimpleraytracing_tpu.utils import profiling as jprof
from unitysimpleraytracing_tpu_torch.utils import profiling as pprof

from _torch_common import CPU


def _work(n):
    x = torch.arange(n, dtype=torch.float32)
    return lambda: (x * 2.0 + 1.0).sum()


def test_fetch_reads_the_first_tensor_of_any_container():
    t = torch.tensor([3.5, 1.0])
    assert pprof.fetch(t) == 3.5
    assert pprof.fetch((None, [t])) == 3.5
    assert pprof.fetch({"a": 2, "b": t}) == 3.5
    scene = pt.build_scene(pt.cube_mesh(size=2.0), device=CPU)
    assert pprof.fetch(scene) == float(scene.triangles.a[0, 0])
    with pytest.raises(TypeError, match="no tensor"):
        pprof.fetch([1, 2])


def test_measure_returns_median_seconds_per_call():
    calls = []

    def fn():
        calls.append(1)
        time.sleep(0.002)
        return torch.zeros(1)

    s = pprof.measure(fn, iters=3, warmup=1, reps=2, device=CPU)
    assert len(calls) == 1 + 3 * 2  # warm-up, then iters samples of reps calls
    assert 0.002 <= s < 0.5
    assert pprof.measure(_work(10), iters=2, warmup=0, reps=1, device=CPU) >= 1e-9


def test_measure_interleaved_is_round_robin():
    order = []

    def make(name, pause):
        def fn():
            order.append(name)
            time.sleep(pause)
            return torch.zeros(1)
        return fn

    got = pprof.measure_interleaved(
        {"slow": make("slow", 0.004), "fast": make("fast", 0.001)},
        iters=3, warmup=1, reps=2, device=CPU)
    # Warm-ups first, each variant's in turn; then one sample of `reps` calls
    # per variant per round.
    assert order[:2] == ["slow", "fast"]
    assert order[2:] == ["slow", "slow", "fast", "fast"] * 3
    assert set(got) == {"slow", "fast"}
    for median, least, samples in got.values():
        assert len(samples) == 3 and least == min(samples) and least <= median
    assert got["slow"][0] > got["fast"][0]


def test_timers_default_to_the_card_and_raise_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device does not raise here")
    with pytest.raises(RuntimeError, match="CUDA"):
        pprof.measure(_work(10))
    with pytest.raises(RuntimeError, match="CUDA"):
        pprof.measure_interleaved({"a": _work(10)})
    with pytest.raises(RuntimeError, match="CUDA"):
        pprof.Profiler()


def test_profiler_collects_ops_and_reports():
    prof = pprof.Profiler(device=CPU)
    scene = pt.build_scene(pt.terrain_mesh(res=20, size=20.0, amplitude=4.0, seed=0), device=CPU)
    with prof.op("build", bytes_accessed=pprof.build_bytes(scene.count)):
        bvh = pt.build_bvh(scene)
        prof.sync(bvh)
    with prof.op("nothing", flops=10):
        pass
    assert [s.name for s in prof.stats] == ["build", "nothing"]
    build = prof.stats[0]
    assert build.seconds > 0 and build.bytes_accessed == pprof.build_bytes(scene.count)
    assert build.gbytes_per_s() == build.bytes_accessed / build.seconds / 1e9
    lines = prof.report().splitlines()
    assert lines[0].split() == ["op", "ms", "GB/s", "GFLOP/s"]
    assert lines[1].startswith("build") and lines[2].startswith("nothing")
    assert len(lines) == 3


def test_opstats_roofline_defaults_are_the_h100_peaks():
    st = pprof.OpStats("x", seconds=1e-3, bytes_accessed=3_350_000_000, flops=0)
    assert st.roofline_fraction() == pytest.approx(1.0)           # 3.35 TB/s
    st = pprof.OpStats("x", seconds=1e-3, bytes_accessed=0, flops=67_000_000_000)
    assert st.roofline_fraction() == pytest.approx(1.0)           # 67 TFLOP/s float32
    assert st.gflops_per_s() == pytest.approx(67_000.0)
    assert pprof.PEAK_BYTES_PER_S == 3.35e12 and pprof.PEAK_F32_OPS_PER_S == 67e12
    # Same formula as the JAX package's, given the same peaks.
    for secs, nbytes, flops in ((2e-3, 10**9, 10**12), (5e-4, 10**10, 10**9)):
        mine = pprof.OpStats("x", secs, nbytes, flops).roofline_fraction(819.0, 197_000.0)
        theirs = jprof.OpStats("x", secs, nbytes, flops).roofline_fraction(819.0, 197_000.0)
        assert mine == theirs
    assert pprof.OpStats("x", 0.0, 1, 1).roofline_fraction() == 0.0


@pytest.mark.parametrize("n", [2, 1000, 65522, 260642, 1048352])
def test_machine_independent_byte_models_equal_jax(n):
    assert pprof.sort_bytes(n) == jprof.sort_bytes(n)
    assert pprof.sort_bytes(n, passes=3) == jprof.sort_bytes(n, passes=3)
    assert pprof.build_bytes(n) == jprof.build_bytes(n)


def test_traverse_bytes_is_the_per_ray_model():
    n_rays, visited = 2_027_520, 75_708
    assert pprof.traverse_bytes(n_rays, visited) == n_rays * 24 + visited * 256 + n_rays * 16
    assert pprof.traverse_bytes(n_rays, visited, pprof.RECORD_BYTES2, False, True) == (
        n_rays * 28 + visited * 128 + n_rays * 16)
    assert pprof.traverse_bytes(10, 0, has_t_init=True, has_thresh=True) == 10 * 32 + 160
    roof = pprof.roofline_ms(n_rays, 0, 0, visited, 13_900_000, 2_160_000)
    assert roof["min_bytes"] == pprof.traverse_bytes(n_rays, visited)
    assert roof["bytes_ms"] == roof["min_bytes"] / 3.35e12 * 1e3
    assert roof["operations"] == 13_900_000 * pprof.OPS_PER_POP + 2_160_000 * pprof.OPS_PER_LEAF_TEST
    assert roof["bound_by"] == "bytes" and roof["bound_ms"] == roof["bytes_ms"]
    heavy = pprof.roofline_ms(32, 0, 0, 1, 10**9, 0, ops_per_pop=pprof.OPS_PER_POP2)
    assert heavy["bound_by"] == "operations" and heavy["bound_ms"] == heavy["operations_ms"]


def test_device_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with pprof.device_trace(str(log_dir), device=CPU) as prof:
        _work(1000)()
    path = log_dir / "trace.json"
    assert path.exists()
    trace = json.loads(path.read_text())
    assert "traceEvents" in trace and len(trace["traceEvents"]) > 0
    assert any("mul" in e.key or "sum" in e.key for e in prof.key_averages())
    assert os.listdir(log_dir) == ["trace.json"]


def test_chip_smoke_takes_its_timer_and_roofline_from_this_module():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    smoke = open(os.path.join(root, "chip_smoke.py"), encoding="utf-8").read()
    assert "from unitysimpleraytracing_tpu_torch.utils.profiling import" in smoke
    assert "class Timer" not in smoke and "def roofline_ms" not in smoke
    assert np.isfinite(pprof.roofline_ms(1, 0, 0, 1, 1, 1)["bound_ms"])
