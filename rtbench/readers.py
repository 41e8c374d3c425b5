"""What the per-layer readers (``rtbench/metrics/<name>.py``) share.  Each
reader takes ``ctx`` (``trace``: a `rtbench.tracing.TraceSlice`; ``unit``:
what a step is; ``passes`` and ``triangles``: the traversals one step needs)
and returns a number, or None where the slice holds nothing to read."""
from __future__ import annotations

from rtbench import stats


def launches_per_step(ctx, unit: str):
    if ctx.unit != unit or not ctx.trace.kernels:
        return None
    return len(ctx.trace.kernels) / ctx.trace.steps


def idle_percent(ctx, unit: str):
    if ctx.unit != unit or not ctx.trace.device:
        return None
    t = ctx.trace
    return 100.0 * stats.idle_share(t.intervals(), t.lo, t.hi)


def span_mean_ms(ctx, span: str):
    times = ctx.trace.spans.get(span)
    return sum(times) / len(times) if times else None


def roofline_percent(ctx, patterns):
    """The least time the slice's traversals need (`stats.traversal_bytes`
    at the published memory rate) over the device time of the kernels whose
    names contain one of ``patterns``, in %."""
    matched = [e for e in ctx.trace.kernels if any(p in e["name"] for p in patterns)]
    if not matched:
        return None
    kernel_s = sum(e["dur"] for e in matched) * 1e-6
    bound_s = (stats.traversal_bytes(ctx.passes, ctx.triangles) * ctx.trace.steps
               / stats.PEAK_BYTES_PER_S)
    return 100.0 * bound_s / kernel_s
