"""The port's own spans (`utils/profiling.span`) and what the benchmark reads
from them (`rtbench/program_spans.py`, the readers in ``rtbench/metrics/``).

On the CPU: with no profiler a span is one shared no-op context and never
reaches ``record_function``; under ``torch.profiler`` a shadowed frame, an
animated frame, the default build and a Karras build record the documented
spans, each inside its documented parent, with outputs bit-identical to the
untraced ones; the helper and the seven readers on a hand-made trace; every
span in the package named in ``PERF.md``'s span table.  Imports nothing of
JAX.  The ``gpu`` test (one step of each cell under CUDA's sync debug mode)
runs on the card:

    python -m pytest tests/test_torch_spans.py -m gpu -n 0 --noconftest
"""
import dataclasses
import json
import os
import re
import sys
import traceback
import warnings
from collections import Counter
from types import SimpleNamespace

import pytest
import torch

import unitysimpleraytracing_tpu_torch as pt
from unitysimpleraytracing_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from rtbench import plugins, program_spans  # noqa: E402
from rtbench.tracing import STEP_RANGE, TraceSlice  # noqa: E402

CPU = "cpu"
REQUEST = "test.request"
READERS = ("raygen_ms.frame", "shade_ms.frame", "refit_ms.frame", "refit_launches.frame",
           "readbacks_per_load", "readback_wait_ms.load", "ingest_host_ms.load")


def _tensors(x):
    """Every tensor of ``x`` (a tensor, or a dataclass holding them), in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if dataclasses.is_dataclass(x):
        return [t for f in dataclasses.fields(x) for t in _tensors(getattr(x, f.name))]
    return []


def _mesh():
    return pt.terrain_mesh(res=12, size=10.0, amplitude=2.0, seed=3)


def _corners(scene, phase):
    t = scene.triangles
    pos = torch.stack([t.a, t.b, t.c], dim=1).clone()
    pos[..., 1] += 0.3 * torch.sin(pos[..., 0] * 0.5 + phase)
    return pos


def _frame_case():
    scene = pt.build_scene(_mesh(), device=CPU)
    bvh = pt.build_bvh(scene)  # a new tree: render_frame packs its table
    tex = pt.solid_texture(device=CPU)

    def step():
        cam = pt.make_camera((8.0, 6.0, 9.0), (0.0, 0.0, 0.0), 64, 32, device=CPU)
        return pt.render_frame(scene, bvh, cam, tex, (0.1, 0.1, 0.12), shadows=True)
    return step


def _animated_case():
    scene = pt.build_scene(_mesh(), device=CPU)
    bvh = pt.build_bvh(scene)
    cam = pt.make_camera((8.0, 6.0, 9.0), (0.0, 0.0, 0.0), 64, 32, device=CPU)
    anim = pt.make_animated_renderer(scene, bvh, cam)
    pos = _corners(scene, 0.7)
    return lambda: anim(pos)


def _default_build_case():
    mesh = _mesh()
    return lambda: pt.build_bvh(pt.build_scene(mesh, device=CPU))


def _karras_case():
    scene = pt.build_scene(_mesh(), device=CPU)
    return lambda: pt.build_bvh(scene, builder="karras")


# Each case: what it runs, and each program span it records with its parent.
CASES = {
    "shadowed_frame": (_frame_case, {
        "camera.make": REQUEST, "render.frame": REQUEST, "tables.pack": "render.frame",
        "readback.parent_links": "tables.pack", "readback.depths": "tables.pack",
        "readback.node_mask": "tables.pack", "readback.plan_rows": "tables.pack",
        "render.rays": "render.frame", "render.primary": "render.frame",
        "render.shadow_rays": "render.frame", "render.shadow": "render.frame",
        "render.shade": "render.frame", "render.compose": "render.frame"}),
    "animated_frame": (_animated_case, {
        "anim.deform": REQUEST, "anim.refit": REQUEST, "anim.tables": REQUEST,
        "anim.trace": REQUEST, "render.rays": "anim.trace", "render.primary": "anim.trace"}),
    "default_build": (_default_build_case, {
        "ingest.pad": REQUEST, "ingest.upload": REQUEST, "ingest.keys": REQUEST,
        "build.sort": REQUEST, "build.sah": REQUEST, "readback.sah_level": "build.sah",
        "build.assemble": REQUEST, "build.refit": REQUEST}),
    "karras_build": (_karras_case, {
        "build.sort": REQUEST, "build.unique": REQUEST, "build.topology": REQUEST,
        "readback.topology_split": "build.topology", "build.refit": REQUEST}),
}


def _profiled(step, tmp_path):
    """``step()`` under `profiling.device_trace` inside a request range: its
    output and the trace's ranges."""
    with profiling.device_trace(str(tmp_path), device=CPU):
        with torch.profiler.record_function(REQUEST):
            out = step()
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    return out, [e for e in events if e.get("cat") == "user_annotation"]


def _parents(ranges):
    """(name, parent name) of every range: the shortest other range on its
    thread that holds it."""
    out = []
    for r in ranges:
        around = [o for o in ranges if o is not r and o["tid"] == r["tid"]
                  and o["ts"] <= r["ts"] and r["ts"] + r["dur"] <= o["ts"] + o["dur"]
                  and o["dur"] >= r["dur"]]
        out.append((r["name"], min(around, key=lambda o: o["dur"])["name"] if around else None))
    return out


def test_off_a_span_is_the_shared_null_context(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("record_function called with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("render.rays") is profiling.span("build.sah")
    with profiling.span("render.rays") as inside:
        assert inside is None
    for make, _ in CASES.values():
        make()()


@pytest.mark.parametrize("case", sorted(CASES))
def test_profiled_spans_nest_as_documented(case, tmp_path):
    make, parents = CASES[case]
    want = make()()
    got, ranges = _profiled(make(), tmp_path)
    assert [torch.equal(a, b) for a, b in zip(_tensors(got), _tensors(want))] \
        == [True] * len(_tensors(want))
    seen = [(n, p) for n, p in _parents(ranges) if program_spans.is_program(n)]
    assert {n for n, _ in seen} == set(parents)
    for name, parent in seen:
        assert parent == parents[name], (name, parent)
    assert [n for n, p in _parents(ranges) if n == REQUEST] == [REQUEST]


def test_the_sah_loop_reads_back_once_a_level(tmp_path):
    mesh = _mesh()
    levels = int(pt.build_bvh(pt.build_scene(mesh, device=CPU), diagnostics=True).depth.max()) + 1
    _, ranges = _profiled(lambda: pt.build_bvh(pt.build_scene(mesh, device=CPU)), tmp_path)
    reads = Counter(r["name"] for r in ranges)["readback.sah_level"]
    # One read at the head of each level, and the one that ends the loop.
    assert reads == levels + 1 and levels > 3


# ---- the benchmark's helper and readers on a hand-made trace --------------------------

def _x(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(ts, corr, tid=1, name="cudaLaunchKernel"):
    return _x(name, "cuda_runtime", ts, 4, tid=tid, corr=corr)


def _device(name, ts, dur, corr, cat="kernel"):
    e = _x(name, cat, ts, dur, corr=corr)
    e["pid"], e["tid"] = 0, 7
    return e


def _hand_made(with_program=True, steps=2):
    """Two steps of a frame: ray set-up, a primary pass holding one read-back,
    a refit, a pad and an upload, and work launched outside any program span
    or from another thread."""
    program = [
        _x("render.rays", "user_annotation", 20, 100),
        _x("render.primary", "user_annotation", 200, 300),
        _x("readback.depths", "user_annotation", 300, 50),
        _x("anim.refit", "user_annotation", 520, 40),
        _x("ingest.pad", "user_annotation", 570, 10),
        _x("ingest.upload", "user_annotation", 580, 5),
        _x("render.shadow_rays", "user_annotation", 700, 20),
        _x("render.primary", "user_annotation", 20, 900, tid=2),
    ]
    events = [
        _x(STEP_RANGE, "user_annotation", 0, 1000),
        _x("pipeline.render", "user_annotation", 10, 950),
        _launch(30, 1), _device("rays_kernel", 40, 40, 1),
        _launch(210, 2), _device("trace_bvh4_kernel", 220, 100, 2),
        _launch(310, 3, name="cudaMemcpyAsync"),
        _device("Memcpy DtoH (Device -> Pageable)", 330, 10, 3, cat="gpu_memcpy"),
        _launch(530, 4), _device("refit_kernel", 540, 6, 4),
        _launch(532, 5), _device("refit_kernel", 550, 4, 5),
        _launch(600, 6), _device("compose_kernel", 610, 20, 6),
        _launch(640, 7, tid=2), _device("other_thread_kernel", 650, 30, 7),
    ] + (program if with_program else [])
    return TraceSlice(events, steps, {})


def test_launches_go_to_the_innermost_program_span():
    t = _hand_made()
    got = program_spans.attribute(t)
    assert got["render.rays"] == pytest.approx(
        {"device_ms": 0.02, "launches": 0.5, "host_ms": 0.05, "occurrences": 0.5})
    # One range on each thread; the kernel of the other thread is its own.
    assert got["render.primary"] == pytest.approx(
        {"device_ms": 0.065, "launches": 1.0, "host_ms": 0.6, "occurrences": 1.0})
    # The copy goes to the read-back inside the pass, and is no kernel.
    assert got["readback.depths"] == pytest.approx(
        {"device_ms": 0.005, "launches": 0.0, "host_ms": 0.025, "occurrences": 0.5})
    assert got["anim.refit"]["launches"] == 1.0
    assert got["render.shadow_rays"]["device_ms"] == 0.0
    owned = program_spans.launches_by_range(t)
    assert [d["name"] for d in owned[None]] == ["compose_kernel"]
    assert program_spans.attributed_share(t) == pytest.approx(160 / 180)
    assert program_spans.attributed_share(_hand_made(with_program=False)) == 0.0


def test_the_seven_readers_on_a_hand_made_trace():
    ctx = SimpleNamespace(trace=_hand_made(), unit="frame")
    read = {m: plugins.load("metrics", m, ROOT).read(ctx) for m in READERS}
    assert read["shade_ms.frame"] is None
    del read["shade_ms.frame"]
    assert read == pytest.approx({
        "raygen_ms.frame": 0.02, "refit_ms.frame": 0.005, "refit_launches.frame": 1.0,
        "readbacks_per_load": 0.5, "readback_wait_ms.load": 0.025,
        "ingest_host_ms.load": 0.0075})
    bare = SimpleNamespace(trace=_hand_made(with_program=False), unit="frame")
    assert {m: plugins.load("metrics", m, ROOT).read(bare) for m in READERS} \
        == dict.fromkeys(READERS)


def test_every_span_of_the_package_is_in_the_span_table():
    pkg = os.path.join(ROOT, "unitysimpleraytracing_tpu_torch")
    names = set()
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(d, f), encoding="utf-8") as src:
                    names |= set(re.findall(r'\bspan\("([a-z_.]+)"\)', src.read()))
    assert len(names) >= 25
    with open(os.path.join(ROOT, "PERF.md"), encoding="utf-8") as f:
        text = f.read()
    table = text[text.index("| Span |"):]
    table = table[:table.index("\n\n")]
    assert all(program_spans.is_program(n) for n in names)
    assert sorted(n for n in names if f"`{n}`" not in table) == []


# ---- on the card ----------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA's sync debug mode exists only there")
    return "cuda"


CELLS = ("terrain260k.orbit", "terrain260k.load", "terrain65k.deform_refit")


def _site(stack):
    """``file:line`` of the innermost frame of the program in ``stack``, or
    None where no frame of the program called."""
    pkg = os.sep + "unitysimpleraytracing_tpu_torch" + os.sep
    inside = [f for f in stack if pkg in f.filename]
    return f"{os.path.basename(inside[-1].filename)}:{inside[-1].lineno}" if inside else None


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_every_device_to_host_read_sits_in_a_readback_span(card, cell, tmp_path):
    """One step of the cell, as the benchmark runs it, under the profiler and
    CUDA's sync debug mode, which warns at every operation that waits for
    the device.  Every device-to-host read lies in a ``readback.*`` span of
    its own, and the program's other waits are its blocking host-to-device
    copies (pageable uploads of small tensors).  A refit frame waits for
    nothing, and its refit and table update are at most three launches."""
    from rtbench import steps, tracing
    from rtbench.manifest import Manifest

    m = Manifest(ROOT)
    c = m.cell(cell)
    kind = steps.make(c["config_data"], c["traffic_data"], 2147483999, card, pt,
                      tracing.Spans(card), ROOT)
    kind.setup()
    for i in range(2):
        kind.step(i)
    torch.cuda.synchronize()
    waits = []

    def keep(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" in str(message):
            waits.append(traceback.extract_stack()[:-1])

    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    with prof:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = keep
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with torch.profiler.record_function(STEP_RANGE):
                    kind.step(2)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as f:
        t = TraceSlice(json.load(f)["traceEvents"], 1, {})
    program = Counter(_site(w) for w in waits if _site(w))
    elsewhere = ["; ".join(f"{os.path.basename(f.filename)}:{f.lineno}" for f in w[-6:])
                 for w in waits if not _site(w)]
    owner = {id(r): r["name"] for r in t.ranges}
    d2h, h2d = [], 0
    for key, ds in program_spans.launches_by_range(t).items():
        for d in ds:
            if d["name"].startswith("Memcpy DtoH"):
                d2h.append(owner.get(key))
            h2d += d["name"].startswith("Memcpy HtoD")
    reads = [r for r in t.ranges if r["name"].startswith(program_spans.READBACK)]
    found = {"cell": cell, "readbacks": dict(Counter(r["name"] for r in reads)),
             "blocking_uploads": h2d, "program_waits": dict(program),
             "waits_outside_the_program": elsewhere}
    print(json.dumps(found))
    assert all(n and n.startswith(program_spans.READBACK) for n in d2h), (Counter(d2h), found)
    assert len(d2h) == len(reads), found
    assert sum(program.values()) == len(reads) + h2d, found
    if cell == "terrain65k.deform_refit":
        # The refit and the record write: one kernel each, nothing read back
        # and nothing uploaded.
        update = program_spans.total(t, ("anim.refit", "anim.tables"), "launches")
        assert update is not None and update <= 3, (update, found)
        assert len(reads) == 0 and h2d == 0 and not program, found
