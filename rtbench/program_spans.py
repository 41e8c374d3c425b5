"""Device work attributed to the program's own spans.

The program names each stage of its work with a profiler range
(``unitysimpleraytracing_tpu_torch.utils.profiling.span``: ``render.*``,
``anim.*``, ``ingest.*``, ``build.*``, ``tables.*``, ``readback.*``,
``camera.*``); in a traced slice they are ``user_annotation`` events beside
the benchmark's own (``core.mesh``, ``pipeline.*``, ``harness.*``).  A device
event (kernel, copy, fill) carries the correlation id of the runtime call
that launched it; that call sits on a host thread inside a stack of ranges,
and the innermost program range there is the span the work belongs to.

`attribute` returns, per span name and per step of the slice: the device ms
of the work it launched, its kernel launches, its own host ms and its
occurrences.  A slice of a program without spans gives an empty dict, so
every reader of it returns None.
"""
from __future__ import annotations

from collections import defaultdict

PROGRAM_PREFIXES = ("camera.", "render.", "anim.", "ingest.", "build.", "tables.", "readback.")
READBACK = "readback."
# The benchmark's spans around its calls into the program (rtbench/kinds);
# ``harness.*`` spans hold the harness's own work.
PROGRAM_CALLS = ("core.", "pipeline.")


def is_program(name: str) -> bool:
    return name.startswith(PROGRAM_PREFIXES)


def _thread(e) -> tuple:
    return e.get("pid"), e.get("tid")


def _innermost(ranges, times):
    """For each time in ``times`` (ascending), the innermost of ``ranges``
    (one thread's ranges, which nest) that holds it, or None.  A sweep with
    a stack that is always a chain of nested ranges: a range is pushed once
    the ranges that ended before it starts are popped, and a time is read
    from the top once the ranges that ended before it are popped."""
    ranges = sorted(ranges, key=lambda e: (e["ts"], -e["dur"]))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(ranges) and ranges[i]["ts"] <= t:
            r = ranges[i]
            i += 1
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < r["ts"]:
                stack.pop()
            stack.append(r)
        while stack and stack[-1]["ts"] + stack[-1]["dur"] < t:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def launches_by_range(trace, keep=is_program):
    """``{id(range): [device events]}`` for the ranges of ``trace.ranges``
    that ``keep`` accepts: each device event of the slice goes to the
    innermost such range around the runtime call that launched it (matched
    by ``args["correlation"]``).  Device events whose call is not in the
    slice, or lies in no such range, go to the key None."""
    calls = {}
    for e in trace.host:
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None and e.get("cat") in ("cuda_runtime", "cuda_driver"):
            calls[corr] = e
    by_thread = defaultdict(list)
    for d in trace.device:
        call = calls.get((d.get("args") or {}).get("correlation"))
        if call is None:
            by_thread[None].append((0.0, d))
        else:
            by_thread[_thread(call)].append((call["ts"] + call["dur"] / 2, d))
    ranges = defaultdict(list)
    for r in trace.ranges:
        if keep(r["name"]):
            ranges[_thread(r)].append(r)
    out = defaultdict(list)
    for thread, items in by_thread.items():
        items.sort(key=lambda x: x[0])
        owners = (_innermost(ranges.get(thread, []), [t for t, _ in items])
                  if thread is not None else [None] * len(items))
        for (_, d), r in zip(items, owners):
            out[None if r is None else id(r)].append(d)
    return out


def attribute(trace) -> dict:
    """``{span name: {"device_ms", "launches", "host_ms", "occurrences"}}``,
    each per step of the slice, for every program span in it."""
    launched = launches_by_range(trace)
    sums = defaultdict(lambda: {"device_ms": 0.0, "launches": 0, "host_ms": 0.0,
                                "occurrences": 0})
    for r in trace.ranges:
        if not is_program(r["name"]):
            continue
        s = sums[r["name"]]
        s["host_ms"] += r["dur"] * 1e-3
        s["occurrences"] += 1
        for d in launched.get(id(r), ()):
            s["device_ms"] += d["dur"] * 1e-3
            s["launches"] += d.get("cat") == "kernel"
    return {name: {k: v / trace.steps for k, v in s.items()} for name, s in sums.items()}


def total(trace, names, key: str):
    """The sum of ``key`` over the spans ``names`` (a name ending in ``.``
    stands for every span it starts), or None where none of them occurs."""
    got = [v[key] for n, v in attribute(trace).items()
           if any(n == m or (m.endswith(".") and n.startswith(m)) for m in names)]
    return sum(got) if got else None


def attributed_share(trace):
    """Of the device time launched inside the benchmark's spans around calls
    into the program (`PROGRAM_CALLS`), the share launched inside a program
    span, or None where those spans launched nothing."""
    inside_calls = launches_by_range(trace, keep=lambda name: name.startswith(PROGRAM_CALLS))
    owned = {id(d) for key, ds in launches_by_range(trace).items() if key is not None
             for d in ds}
    called = [d for key, ds in inside_calls.items() if key is not None for d in ds]
    total_us = sum(d["dur"] for d in called)
    if not total_us:
        return None
    return sum(d["dur"] for d in called if id(d) in owned) / total_us
