"""The benchmark's arithmetic on synthetic numbers."""
from __future__ import annotations

import statistics

import pytest

from rtbench import readers, stats
from rtbench.tracing import STEP_RANGE, TraceSlice


def test_union_gaps_and_idle_share():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.8), (9, 12)]
    assert stats.union_length(iv, 0, 10) == pytest.approx(3 + 1 + 1)
    assert stats.gaps(iv, 0, 10) == [(3, 5), (6, 9)]
    assert stats.idle_share(iv, 0, 10) == pytest.approx(0.5)
    assert stats.union_length([], 0, 10) == 0
    assert stats.gaps([], 0, 10) == [(0, 10)]


def test_window_rate_and_percentile_over_every_step():
    assert stats.window_ms(2.0, 400) == pytest.approx(5.0)
    with pytest.raises(ValueError):
        stats.window_ms(2.0, 0)
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile(xs, 50) == pytest.approx(statistics.median(xs))
    assert stats.percentile([3.0], 95) == 3.0
    # One slow step among many moves the 95th percentile only if it is in the tail.
    lat = [1.0] * 97 + [50.0] * 3
    assert stats.percentile(lat, 95) == pytest.approx(1.0)
    assert stats.percentile([1.0] * 94 + [50.0] * 6, 95) == pytest.approx(50.0)


def test_byte_bound_of_the_orbit_frame():
    rays, tris = 1920 * 1056, 260_642
    got = stats.traversal_bytes([(rays, False), (rays, True)], tris)
    # Primary: origin, direction and hit; shadow: origin, limit and one flag.
    assert got == rays * (24 + 16) + rays * (16 + 1) + 2 * tris * 36
    assert 130e6 < got < 140e6
    assert got / stats.PEAK_BYTES_PER_S * 1e3 == pytest.approx(0.0401, abs=1e-4)


def _trace(kernels, steps=((0, 100), (100, 200))):
    ev = [{"ph": "X", "cat": "user_annotation", "name": STEP_RANGE, "ts": a, "dur": b - a}
          for a, b in steps]
    ev += [{"ph": "X", "cat": "kernel", "name": n, "ts": a, "dur": d} for n, a, d in kernels]
    ev += [{"ph": "X", "cat": "cpu_op", "name": "aten::nonzero", "ts": 60, "dur": 30},
           {"ph": "X", "cat": "user_annotation", "name": "pipeline.build", "ts": 50, "dur": 60}]
    return TraceSlice(ev, len(steps), {"pipeline.build": [2.0, 4.0]})


def test_trace_slice_readers_and_breakdown():
    t = _trace([("void trace_bvh4_kernel<Layout<false> >(float4 const*)", 10, 20),
                ("elementwise", 20, 20), ("trace_bvh4_kernel", 120, 40)])
    assert t.window_s == pytest.approx(200e-6)
    assert t.busy_s == pytest.approx(70e-6)
    ctx = type("C", (), {"trace": t, "unit": "frame", "passes": [(1000, False)],
                         "triangles": 10})()
    assert readers.launches_per_step(ctx, "frame") == 1.5
    assert readers.launches_per_step(ctx, "load") is None
    assert readers.idle_percent(ctx, "frame") == pytest.approx(65.0)
    assert readers.span_mean_ms(ctx, "pipeline.build") == 3.0
    assert readers.span_mean_ms(ctx, "core.mesh") is None
    bound_s = stats.traversal_bytes([(1000, False)], 10) * 2 / stats.PEAK_BYTES_PER_S
    assert readers.roofline_percent(ctx, ("trace_bvh4_kernel",)) == pytest.approx(
        100 * bound_s / 60e-6)
    assert readers.roofline_percent(ctx, ("no_such_kernel",)) is None
    b = t.breakdown()
    assert b["device_ops"][0][0] == "trace_bvh4_kernel"
    assert b["idle_gaps"][0] == ["pipeline.build / aten::nonzero", pytest.approx(80e-6)]


def test_no_device_activity_reads_nothing():
    t = _trace([])
    ctx = type("C", (), {"trace": t, "unit": "frame", "passes": [(1, False)], "triangles": 1})()
    assert readers.idle_percent(ctx, "frame") is None
    assert readers.launches_per_step(ctx, "frame") is None
    assert readers.roofline_percent(ctx, ("trace_bvh4_kernel",)) is None
