"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card.  Imports nothing of JAX.  Run on a machine with an NVIDIA GPU:

    python -m pytest tests/test_torch_kernel_gpu.py -m gpu -n 0 --noconftest

Without a CUDA device every test here skips (``chip_smoke.py`` makes the same
comparison at full size and is the gate for the kernel)."""
import numpy as np
import pytest
import torch

import unitysimpleraytracing_tpu_torch as pt
from unitysimpleraytracing_tpu_torch import constants as C
from unitysimpleraytracing_tpu_torch.ops import (
    dispatch, scan, sort, sort_radix_cuda, trace_bvh2, trace_bvh4,
)
from unitysimpleraytracing_tpu_torch.utils.parity import assert_hit_parity

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpreter form")
    return torch.device("cuda")


def _np(h):
    from types import SimpleNamespace

    return SimpleNamespace(**{k: getattr(h, k).cpu().numpy() for k in ("t", "tri", "u", "v")})


def _rays(n, seed, bound, dev):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-bound, bound, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)


@pytest.mark.parametrize("scene_name", ["cube", "soup", "terrain"])
def test_kernel_bit_identical_to_plain(card, scene_name):
    mesh = {
        "cube": lambda: pt.cube_mesh(size=2.0),
        "soup": lambda: pt.random_triangle_soup(3000, seed=7, bound=5.0, tri_size=1.0),
        "terrain": lambda: pt.terrain_mesh(res=64, size=20.0, amplitude=4.0, seed=0),
    }[scene_name]()
    scene = pt.build_scene(mesh)
    bvh = pt.build_bvh(scene, builder="karras")
    table = trace_bvh4.prepare_tables4(scene, bvh)
    o, d = _rays(10000, seed=3, bound=8.0, dev=card)
    before = trace_bvh4.traverse_bvh4.launches
    got, steps = trace_bvh4.traverse_bvh4(table, o, d, count_steps=True)
    torch.cuda.synchronize()
    assert trace_bvh4.traverse_bvh4.launches == before + 1
    want, wsteps = trace_bvh4.traverse_bvh4_plain(table, o, d, count_steps=True)
    assert_hit_parity(_np(got), _np(want), exact=True)
    assert torch.equal(steps, wsteps)
    # any-hit and t_init through the same kernel
    thr = torch.full((10000,), 9.0, device=card)
    g = trace_bvh4.traverse_bvh4(table, o, d, anyhit_thresh=thr)
    w = trace_bvh4.traverse_bvh4_plain(table, o, d, anyhit_thresh=thr)
    assert torch.equal(g.t, w.t) and torch.equal(g.tri, w.tri)
    seed_t = torch.where(got.hit, got.t + 0.01, got.t)
    g = trace_bvh4.traverse_bvh4(table, o, d, t_init=seed_t)
    assert torch.equal(g.t[got.hit], got.t[got.hit])


@pytest.mark.parametrize("scene_name", ["cube", "soup", "terrain"])
def test_kernel_bit_identical_to_plain_default_tree(card, scene_name):
    """The default (sah_free) tree, which users trace: t, tri, u, v and the
    records popped per ray, for nearest hit, any-hit and t_init."""
    mesh = {
        "cube": lambda: pt.cube_mesh(size=2.0),
        "soup": lambda: pt.random_triangle_soup(3000, seed=7, bound=5.0, tri_size=1.0),
        "terrain": lambda: pt.terrain_mesh(res=64, size=20.0, amplitude=4.0, seed=0),
    }[scene_name]()
    scene = pt.build_scene(mesh)
    table = trace_bvh4.prepare_tables4(scene, pt.build_bvh(scene))
    o, d = _rays(10000, seed=3, bound=8.0, dev=card)
    thr = torch.full((10000,), 9.0, device=card)
    for kw in ({}, {"anyhit_thresh": thr}):
        got, steps = trace_bvh4.traverse_bvh4(table, o, d, count_steps=True, **kw)
        want, wsteps = trace_bvh4.traverse_bvh4_plain(table, o, d, count_steps=True, **kw)
        _assert_same_bits(got, want)
        assert torch.equal(steps, wsteps)
    seed_t = torch.where(got.hit, got.t + 0.01, got.t)
    got, steps = trace_bvh4.traverse_bvh4(table, o, d, t_init=seed_t, count_steps=True)
    want, wsteps = trace_bvh4.traverse_bvh4_plain(table, o, d, t_init=seed_t, count_steps=True)
    _assert_same_bits(got, want)
    assert torch.equal(steps, wsteps)


def _assert_same_bits(got, want):
    for f in ("t", "u", "v"):
        assert torch.equal(getattr(got, f).view(torch.int32), getattr(want, f).view(torch.int32)), f
    assert torch.equal(got.tri, want.tri)


def _chain_table(levels: int, dev):
    """A record table whose walk needs the deepest stack a tree may need:
    record i (i < levels) has four internal entries whose boxes every ray
    hits; entry 0 leads to record i + 1 (record ``levels`` has only EMPTY
    entries), entries 1-3 to that EMPTY record.  A ray travelling in +x
    visits entry 0 first and keeps three entries on the stack per level."""
    big, empty_meta = 1.0e3, float(1 << 21)
    rows = []
    for i in range(levels + 1):
        rec = np.zeros(64, np.float32)
        for e in range(4):
            child = i + 1 if e == 0 else levels
            if i < levels:
                rec[6 * e: 6 * e + 6] = [-big, -big, -big, big, big, big]
                rec[24 + e] = float(min(child, levels))
            else:
                rec[6 * e: 6 * e + 6] = [3e38, 3e38, 3e38, -3e38, -3e38, -3e38]
                rec[24 + e] = empty_meta
        rows.append(rec)
    return torch.from_numpy(np.stack(rows)).to(dev)


def test_kernel_at_the_stack_limit_equals_plain(card):
    """21 levels of three pushed entries: 64 stack entries, the most a walk
    may hold without the kernel trapping (one level more would trap)."""
    table = _chain_table(21, card)
    o, d = _rays(96, seed=5, bound=0.5, dev=card)
    d[:64, 0] = d[:64, 0].abs() + 0.1  # these travel in +x: the deep order
    d = d / d.norm(dim=1, keepdim=True)
    got, steps = trace_bvh4.traverse_bvh4(table, o, d, count_steps=True)
    want, wsteps = trace_bvh4.traverse_bvh4_plain(table, o, d, count_steps=True)
    torch.cuda.synchronize()
    _assert_same_bits(got, want)
    assert torch.equal(steps, wsteps)
    # 21 chain records, three EMPTY-record entries pushed by each, and the
    # last record's entry 0.
    assert int(wsteps.max()) == 21 + 21 * 3 + 1 and not bool(got.hit.any())


@pytest.mark.parametrize("n", [1, 31, 33, 127, 129, 1000, 4099])
def test_kernel_ragged_ray_counts(card, n):
    """Ray counts that are not a multiple of a warp's run of rays."""
    scene = pt.build_scene(pt.random_triangle_soup(3000, seed=7, bound=5.0, tri_size=1.0))
    table = trace_bvh4.prepare_tables4(scene, pt.build_bvh(scene))
    o, d = _rays(n, seed=n, bound=8.0, dev=card)
    got, steps = trace_bvh4.traverse_bvh4(table, o, d, count_steps=True)
    want, wsteps = trace_bvh4.traverse_bvh4_plain(table, o, d, count_steps=True)
    _assert_same_bits(got, want)
    assert torch.equal(steps, wsteps) and steps.shape == (n,)


def test_auto_dispatch_launches_the_kernel_on_cuda_rays(card):
    scene = pt.build_scene(pt.cube_mesh(size=2.0))
    bvh = pt.build_bvh(scene, builder="karras")
    o, d = _rays(1000, seed=1, bound=4.0, dev=card)  # ragged: padded to a warp
    before = trace_bvh4.traverse_bvh4.launches
    hits = dispatch.trace_rays(scene, bvh, o, d)
    assert trace_bvh4.traverse_bvh4.launches == before + 1
    ref = dispatch.trace_rays(scene, bvh, o, d, impl="perray")
    assert_hit_parity(_np(hits), _np(ref), exact=True)
    assert trace_bvh4.traverse_bvh4.launches == before + 1  # perray: no launch


def test_wrapper_raises_on_mixed_devices(card):
    scene = pt.build_scene(pt.cube_mesh(size=2.0))
    bvh = pt.build_bvh(scene, builder="karras")
    table = trace_bvh4.prepare_tables4(scene, bvh)
    o, d = _rays(64, seed=1, bound=4.0, dev=card)
    with pytest.raises(ValueError, match="is on"):
        trace_bvh4.traverse_bvh4(table.cpu(), o, d)


# ---- K3 digit histogram, K4 stable rank, K5 exclusive scan ---------------
# Tolerance: bit-identical (integer kernels); float32 scan within 1e-5 of the
# running sum of magnitudes (the kernel sums in tree order).

_SHIFTS = [0, 8, 16, 24]


def _keys(kind, n, dev):
    rng = np.random.default_rng(n)
    if kind == "random":
        k = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.int64)
    elif kind == "duplicates":
        k = rng.choice([0, 1, 5, 1 << 29, (1 << 30) - 1], size=n).astype(np.int64)
    elif kind == "equal":
        k = np.full(n, 0x12345678, np.int64)
    else:
        k = np.full(n, C.KEY_PADDING, np.int64)
    return torch.from_numpy(k).to(dev)


@pytest.mark.parametrize("kind", ["random", "duplicates", "equal", "padding"])
def test_histogram_and_rank_bit_identical_to_plain(card, kind):
    keys = _keys(kind, 64 * 1024, card)
    for shift in _SHIFTS:
        h0, r0 = sort_radix_cuda.digit_histogram.launches, sort_radix_cuda.digit_rank.launches
        hist_t = sort_radix_cuda.digit_histogram(keys, shift)
        bases = scan.exclusive_scan(hist_t)
        dst = sort_radix_cuda.digit_rank(keys, bases, shift)
        torch.cuda.synchronize()
        assert sort_radix_cuda.digit_histogram.launches == h0 + 1
        assert sort_radix_cuda.digit_rank.launches == r0 + 1
        assert torch.equal(hist_t, sort_radix_cuda.digit_histogram_plain(keys, shift))
        assert torch.equal(bases, scan.exclusive_scan_plain(hist_t))
        assert torch.equal(dst, sort_radix_cuda.digit_rank_plain(keys, bases, shift))
        assert hist_t.dtype == bases.dtype == dst.dtype == torch.int32
        assert torch.equal(torch.sort(dst).values.int(),
                           torch.arange(keys.shape[0], device=card, dtype=torch.int32))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 5000, 262144, (1 << 20) + 3])
def test_scan_int_bit_identical_to_plain(card, n, dtype):
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.integers(0, 9, size=n)).to(card, dtype)
    calls, dev = scan.exclusive_scan.launches, scan.exclusive_scan.device_launches
    got = scan.exclusive_scan(x)
    torch.cuda.synchronize()
    assert scan.exclusive_scan.launches == calls + 1
    assert scan.exclusive_scan.device_launches == dev + 1  # one launch for every n
    assert got.dtype == dtype
    assert torch.equal(got, scan.exclusive_scan_plain(x))


def _scan_inputs(n, dtype, dev):
    rng = np.random.default_rng(n)
    if dtype == torch.float32:
        rand = rng.normal(size=n).astype(np.float32)
    elif dtype == torch.int64:
        rand = rng.integers(0, 1 << 40, size=n)
    else:
        rand = rng.integers(-1000, 1025, size=n).astype(np.int32)
    return [torch.from_numpy(np.asarray(a)).to(dev, dtype)
            for a in (rand, np.zeros(n), np.ones(n))]


def _assert_scan_right(got, x):
    if x.dtype == torch.float32:
        xs = x.double().cpu().numpy()
        want = scan.exclusive_scan_reference(xs)
        bound = 1e-5 * np.maximum(scan.exclusive_scan_reference(np.abs(xs)), 1.0)
        assert np.all(np.abs(got.double().cpu().numpy() - want) <= bound)
    else:
        assert torch.equal(got, scan.exclusive_scan_plain(x))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float32])
@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 65280, 262144, (1 << 22) + 3])
def test_scan_lookback_at_tile_edges_and_path_sizes(card, n, dtype):
    """One launch per call; integer types bit-identical to the plain version,
    float32 within 1e-5 of the running sum of magnitudes; random values, all
    zeros and all ones."""
    for x in _scan_inputs(n, dtype, card):
        dev = scan.exclusive_scan.device_launches
        got = scan.exclusive_scan(x)
        torch.cuda.synchronize()
        assert scan.exclusive_scan.device_launches == dev + 1
        assert got.dtype == dtype and got.shape == x.shape
        _assert_scan_right(got, x)


def test_scan_100_calls_in_a_row_on_one_scratch(card):
    """Stale status words of earlier calls must read as unpublished: 100
    calls on one stream's scratch, sizes and dtypes mixed, each checked."""
    rng = np.random.default_rng(9)
    sizes = [int(s) for s in rng.choice([1, 4095, 4097, 65280, 262144, 300000], size=100)]
    dtypes = [torch.int32, torch.int64, torch.float32]
    inputs = [_scan_inputs(n, dtypes[i % 3], card)[0] for i, n in enumerate(sizes)]
    dev = scan.exclusive_scan.device_launches
    outs = [scan.exclusive_scan(x) for x in inputs]
    torch.cuda.synchronize()
    assert scan.exclusive_scan.device_launches == dev + 100
    for got, x in zip(outs, inputs):
        _assert_scan_right(got, x)


def test_scan_streams_do_not_share_scratch(card):
    x = _scan_inputs(262144, torch.int32, card)[0]
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        got_side = scan.exclusive_scan(x)
    got_main = scan.exclusive_scan(x)
    torch.cuda.synchronize()
    assert torch.equal(got_side, got_main)
    _assert_scan_right(got_main, x)
    keys = [k for k in scan._SCRATCH if k[0] == x.device.index]
    assert (x.device.index, side.cuda_stream) in keys and len(keys) >= 2


def test_scan_replays_from_a_cuda_graph(card):
    """A captured call replays right 100 times, with eager calls of another
    size on the same stream's scratch in between: the epoch and the tickets
    move on the device, not in the call's arguments."""
    n = 262144 + 5
    static_x = torch.zeros(n, dtype=torch.int32, device=card)
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        scan.exclusive_scan(static_x)  # builds the kernel and this stream's scratch
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=s):
        static_out = scan.exclusive_scan(static_x)
    rng = np.random.default_rng(11)
    for i in range(100):
        x = torch.from_numpy(rng.integers(-1000, 1025, size=n).astype(np.int32)).to(card)
        y = _scan_inputs(4097 + i, torch.int64, card)[0]
        with torch.cuda.stream(s):
            static_x.copy_(x)
            g.replay()
            got_y = scan.exclusive_scan(y)
        torch.cuda.synchronize()
        assert torch.equal(static_out, scan.exclusive_scan_plain(x)), i
        assert torch.equal(got_y, scan.exclusive_scan_plain(y)), i


def test_scan_replays_after_a_larger_eager_call(card):
    """A graph captured at one size replays right after an eager call of MORE
    tiles has grown the stream's scratch: the words the capture used stay
    alive, and the eager calls move to the new words."""
    n = 65536 + 3
    static_x = torch.zeros(n, dtype=torch.int32, device=card)
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        scan.exclusive_scan(static_x)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=s):
        static_out = scan.exclusive_scan(static_x)
    scratch = scan._SCRATCH[(static_x.device.index, s.cuda_stream)]
    captured_words = scratch.words
    rng = np.random.default_rng(12)
    for i, big in enumerate((1 << 22) + 7 + np.arange(3) * 4096 * 300):
        y = _scan_inputs(int(big), torch.int32, card)[0]
        x = torch.from_numpy(rng.integers(-1000, 1025, size=n).astype(np.int32)).to(card)
        with torch.cuda.stream(s):
            got_y = scan.exclusive_scan(y)  # more tiles: the scratch grows
            static_x.copy_(x)
            g.replay()
            got_y2 = scan.exclusive_scan(y)
        torch.cuda.synchronize()
        assert torch.equal(static_out, scan.exclusive_scan_plain(x)), i
        assert torch.equal(got_y, scan.exclusive_scan_plain(y)), i
        assert torch.equal(got_y2, got_y), i
    assert any(w is captured_words for w in scratch.kept)
    assert scratch.words is not captured_words


def test_scan_float_within_tolerance(card):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1 << 20) + 77).astype(np.float32)
    got = scan.exclusive_scan(torch.from_numpy(x).to(card)).cpu().numpy()
    want = scan.exclusive_scan_reference(x.astype(np.float64))
    bound = 1e-5 * np.maximum(scan.exclusive_scan_reference(np.abs(x).astype(np.float64)), 1.0)
    assert np.all(np.abs(got - want) <= bound)


_LAUNCH_COUNTERS = ("digit_counts", "digit_pass", "digit_histogram", "digit_rank")


def _sort_launches():
    return (*(getattr(sort_radix_cuda, f).launches for f in _LAUNCH_COUNTERS),
            scan.exclusive_scan.launches, scan.exclusive_scan.device_launches)


@pytest.mark.parametrize("n", [1, 1023, 1025, 5000, 1 << 20])
def test_cuda_sort_equals_stable_torch_sort_and_counts_launches(card, n):
    """One sort is exactly six launches: the count, K5 over its 1024 counts,
    and four passes; nothing of the per-block forms."""
    keys = _keys("random", n, card)
    vals = torch.arange(n, dtype=torch.int32, device=card)
    before = _sort_launches()
    ko, vo = sort.sort_key_val(keys, vals, impl="cuda")
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_sort_launches(), before)) == (1, 4, 0, 0, 1, 1)
    wk, wv = sort.sort_key_val(keys, vals, impl="torch")
    assert torch.equal(ko, wk) and torch.equal(vo, wv)


# The acceptance list of the count and the pass: every size, every key kind,
# every shift, every output bit-identical to the plain versions.
_PASS_SIZES = [1, 1023, 1024, 1025, 1 << 20, (1 << 22) + 3]


@pytest.mark.parametrize("kind", ["random", "duplicates", "equal", "padding"])
@pytest.mark.parametrize("n", _PASS_SIZES)
def test_count_and_pass_bit_identical_to_plain(card, n, kind):
    keys = _keys(kind, n, card)
    vals = torch.from_numpy(np.random.default_rng(n).permutation(n).astype(np.int32)).to(card)
    before = sort_radix_cuda.digit_counts.launches
    counts = sort_radix_cuda.digit_counts(keys)
    torch.cuda.synchronize()
    assert sort_radix_cuda.digit_counts.launches == before + 1
    want_counts = sort_radix_cuda.digit_counts_plain(keys)
    assert torch.equal(counts, want_counts)
    for shift in _SHIFTS:
        d = sort.digit_of(keys, shift)
        assert torch.equal(counts[shift * 32:shift * 32 + 256].long(), torch.bincount(d, minlength=256))
    bases = scan.exclusive_scan(counts)
    for shift in _SHIFTS:
        before = sort_radix_cuda.digit_pass.launches
        got = sort_radix_cuda.digit_pass(keys, vals, bases, shift, observe=True)
        torch.cuda.synchronize()
        assert sort_radix_cuda.digit_pass.launches == before + 1
        want = sort_radix_cuda.digit_pass_plain(keys, vals, bases, shift)
        for name, g, w in zip(("keys_out", "values_out", "dst", "hist_t", "scanned"), got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), (name, shift)
        # Without the observables the same keys and values move.
        ko, vo = sort_radix_cuda.digit_pass(keys, vals, bases, shift)
        assert torch.equal(ko, want[0]) and torch.equal(vo, want[1]), shift
        # Stable by the digit: the permutation of a stable sort is unique.
        order = torch.sort(sort.digit_of(keys, shift), stable=True).indices
        assert torch.equal(ko, keys[order]) and torch.equal(vo, vals[order]), shift
    if n % 1024 == 0:
        for shift in _SHIFTS:
            hist_t = sort_radix_cuda.digit_histogram(keys, shift)
            scanned = scan.exclusive_scan(hist_t)
            dst = sort_radix_cuda.digit_rank(keys, scanned, shift)
            torch.cuda.synchronize()
            assert torch.equal(hist_t, sort_radix_cuda.digit_histogram_plain(keys, shift))
            assert torch.equal(dst, sort_radix_cuda.digit_rank_plain(keys, scanned, shift))
            debug = sort_radix_cuda.cuda_pass_debug(keys, vals, shift)
            assert torch.equal(debug[2], hist_t) and torch.equal(debug[3], scanned)


def test_pass_moves_float_values_as_bits_and_refuses_other_widths(card):
    keys = _keys("duplicates", 5000, card)
    vals = torch.from_numpy(np.random.default_rng(3).normal(size=5000).astype(np.float32)).to(card)
    vals[7] = float("nan")
    vals[9] = -0.0
    ko, vo = sort.sort_key_val(keys, vals, impl="cuda")
    order = torch.sort(keys, stable=True).indices
    assert torch.equal(ko, keys[order])
    assert torch.equal(vo.view(torch.int32), vals[order].view(torch.int32))
    for bad in (vals.double(), vals.half(), vals.long()):
        with pytest.raises(TypeError, match="4-byte"):
            sort.sort_key_val(keys, bad, impl="cuda")


def test_cuda_sort_replays_from_a_graph_after_a_larger_eager_call(card):
    """A sort captured in a CUDA graph replays bit-identical after eager
    sorts of more tiles have grown the stream's scratch: the words the
    capture used stay alive, and the eager calls move to the new ones."""
    n = 65536 + 3
    static_k = _keys("random", n, card).clone()
    static_v = torch.arange(n, dtype=torch.int32, device=card)
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        sort.sort_key_val(static_k, static_v, impl="cuda")  # builds the kernels and the scratch
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=s):
        out_k, out_v = sort.sort_key_val(static_k, static_v, impl="cuda")
    scratch = sort_radix_cuda._SCRATCH[(static_k.device.index, s.cuda_stream)]
    captured_words = scratch.words
    rng = np.random.default_rng(13)
    for i, big in enumerate(((1 << 22) + 3, (1 << 22) + 4099, (1 << 20) + 1)):
        y = torch.from_numpy(rng.integers(0, 2**32, size=big, dtype=np.uint64).astype(np.int64)).to(card)
        yv = torch.arange(big, dtype=torch.int32, device=card)
        x = torch.from_numpy(rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.int64)).to(card)
        with torch.cuda.stream(s):
            got_y = sort.sort_key_val(y, yv, impl="cuda")  # more tiles: the scratch grows
            static_k.copy_(x)
            g.replay()
            got_y2 = sort.sort_key_val(y, yv, impl="cuda")
        torch.cuda.synchronize()
        wk, perm = torch.sort(x, stable=True)
        assert torch.equal(out_k, wk) and torch.equal(out_v, perm.int()), i
        wy, py = torch.sort(y, stable=True)
        assert torch.equal(got_y[0], wy) and torch.equal(got_y[1], py.int()), i
        assert torch.equal(got_y2[0], wy) and torch.equal(got_y2[1], py.int()), i
    assert any(w is captured_words for w in scratch.kept)
    assert scratch.words is not captured_words


def test_pass_stops_on_bases_that_do_not_belong_to_the_keys(card):
    """Bases that would move a key past the output trap the kernel instead of
    writing there; in a process of its own, since a trap ends the CUDA
    context."""
    import os
    import subprocess
    import sys

    code = (
        "import torch\n"
        "from unitysimpleraytracing_tpu_torch.ops import sort_radix_cuda as R\n"
        "k = torch.arange(8192, dtype=torch.int64, device='cuda')\n"
        "v = torch.zeros(8192, dtype=torch.int32, device='cuda')\n"
        "b = torch.full((1024,), 1 << 20, dtype=torch.int32, device='cuda')\n"
        "R.digit_pass(k, v, b, 0)\n"
        "torch.cuda.synchronize()\n"
        "print('no trap')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=root,
                         timeout=300, env=dict(os.environ, PYTHONPATH=root))
    assert res.returncode != 0 and "no trap" not in res.stdout, res.stdout


def test_hundred_sorts_in_a_row_on_one_scratch(card):
    """The epochs and the count's totals move on the device from call to
    call: 100 sorts of changing sizes on one stream, each right."""
    rng = np.random.default_rng(14)
    for i in range(100):
        n = int(rng.integers(1, 300000))
        kind = ("random", "duplicates", "equal", "padding")[i % 4]
        keys = _keys(kind, n, card) if i % 5 else torch.from_numpy(
            rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.int64)).to(card)
        vals = torch.arange(n, dtype=torch.int32, device=card)
        ko, vo = sort.sort_key_val(keys, vals, impl="cuda")
        wk, perm = torch.sort(keys, stable=True)
        assert torch.equal(ko, wk) and torch.equal(vo, perm.int()), (i, n, kind)


def test_sort_wrappers_raise_on_what_the_kernels_do_not_take(card):
    keys = _keys("random", 2048, card)
    with pytest.raises(TypeError):
        sort_radix_cuda.digit_histogram(keys.int(), 0)
    with pytest.raises(ValueError):
        sort_radix_cuda.digit_histogram(keys[:1000], 0)
    with pytest.raises(ValueError):
        sort_radix_cuda.digit_histogram(keys, 4)
    bases = torch.zeros(512, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="are on"):
        sort_radix_cuda.digit_rank(keys, bases.cpu(), 0)
    with pytest.raises(TypeError):
        scan.exclusive_scan(torch.zeros(8, dtype=torch.float64, device=card))


# ---- K2 binary-record traversal, and the dynamic paths on the card ---------
# Tolerance: bit-identical to the plain version (same float32 operations in
# the same order, -fmad=false); between the two record formats the parity
# contract (hit masks identical, tri flips only at exact-t ties).

_MESHES = {
    "cube": lambda: pt.cube_mesh(size=2.0),
    "soup": lambda: pt.random_triangle_soup(3000, seed=7, bound=5.0, tri_size=1.0),
    "terrain": lambda: pt.terrain_mesh(res=64, size=20.0, amplitude=4.0, seed=0),
}


@pytest.mark.parametrize("scene_name", sorted(_MESHES))
def test_kernel2_bit_identical_to_plain(card, scene_name):
    scene = pt.build_scene(_MESHES[scene_name]())
    bvh = pt.build_bvh(scene, builder="karras")
    table = trace_bvh2.prepare_tables(scene, bvh)
    o, d = _rays(10000, seed=3, bound=8.0, dev=card)
    before = trace_bvh2.traverse_bvh2.launches
    got, steps = trace_bvh2.traverse_bvh2(table, o, d, count_steps=True)
    torch.cuda.synchronize()
    assert trace_bvh2.traverse_bvh2.launches == before + 1
    want, wsteps = trace_bvh2.traverse_bvh2_plain(table, o, d, count_steps=True)
    assert_hit_parity(_np(got), _np(want), exact=True)
    assert torch.equal(got.tri, want.tri) and torch.equal(steps, wsteps)
    # any-hit and t_init through the same kernel
    thr = torch.full((10000,), 9.0, device=card)
    g, gs = trace_bvh2.traverse_bvh2(table, o, d, anyhit_thresh=thr, count_steps=True)
    w, ws = trace_bvh2.traverse_bvh2_plain(table, o, d, anyhit_thresh=thr, count_steps=True)
    assert torch.equal(g.t, w.t) and torch.equal(g.tri, w.tri) and torch.equal(gs, ws)
    assert bool((gs <= steps).all())
    seed_t = torch.where(got.hit, got.t + 0.01, got.t)
    g = trace_bvh2.traverse_bvh2(table, o, d, t_init=seed_t)
    w = trace_bvh2.traverse_bvh2_plain(table, o, d, t_init=seed_t)
    assert torch.equal(g.t, w.t) and torch.equal(g.tri, w.tri)
    assert torch.equal(g.t[got.hit], got.t[got.hit])
    # ... and the BVH4 kernel on the same rays: the parity contract.
    four = trace_bvh4.traverse_bvh4(trace_bvh4.prepare_tables4(scene, bvh), o, d)
    assert_hit_parity(_np(got), _np(four))


def test_cuda2_dispatch_ragged_batch_and_capacity(card):
    scene = pt.build_scene(pt.cube_mesh(size=2.0))
    bvh = pt.build_bvh(scene, builder="karras")
    o, d = _rays(1000, seed=1, bound=4.0, dev=card)  # ragged: padded to a warp
    b2, b4 = trace_bvh2.traverse_bvh2.launches, trace_bvh4.traverse_bvh4.launches
    hits = dispatch.trace_rays(scene, bvh, o, d, impl="cuda2")
    assert trace_bvh2.traverse_bvh2.launches == b2 + 1
    assert trace_bvh4.traverse_bvh4.launches == b4
    assert hits.t.shape == (1000,)
    ref = dispatch.trace_rays(scene, bvh, o, d, impl="perray")
    assert_hit_parity(_np(hits), _np(ref), exact=True)
    plain = dispatch.trace_rays(scene, bvh, o, d, impl="plain2")
    assert torch.equal(plain.t, hits.t) and torch.equal(plain.tri, hits.tri)
    assert trace_bvh2.traverse_bvh2.launches == b2 + 1  # plain2, perray: no launch
    assert torch.equal(dispatch.occluded(scene, bvh, o, d, impl="cuda2"),
                       dispatch.occluded(scene, bvh, o, d, impl="perray"))
    with pytest.raises(ValueError, match="is on"):
        trace_bvh2.traverse_bvh2(trace_bvh2.prepare_tables(scene, bvh).cpu(), o, d)
    with pytest.raises(dispatch.CapacityError, match="cuda4"):
        dispatch.resolve_impl("cuda2", 1 << 20, card)


@pytest.mark.parametrize("impl", ["cuda4", "cuda2"])
@pytest.mark.parametrize("shadows", [False, True])
def test_render_frames_on_the_card_equals_per_frame(card, impl, shadows):
    scene = pt.build_scene(pt.terrain_mesh(res=48, size=40.0, amplitude=6.0, seed=0))
    bvh = pt.build_bvh(scene, builder="karras")
    tex = pt.solid_texture((0.8, 0.7, 0.6, 1.0))
    bg = np.asarray([0.1, 0.1, 0.12], np.float32)
    cams = [pt.make_camera(eye=(30 * np.cos(a), 25.0, 30 * np.sin(a)), target=(0, 0, 0),
                           width=128, height=96) for a in (0.1, 1.3, 2.9)]
    wrapper = (trace_bvh4.traverse_bvh4 if impl == "cuda4" else trace_bvh2.traverse_bvh2)
    before = wrapper.launches
    batch = pt.render_frames(scene, bvh, pt.stack_cameras(cams), tex, bg, impl=impl,
                             shadows=shadows)
    assert wrapper.launches == before + (2 if shadows else 1)
    assert tuple(batch.shape) == (3, 96, 128, 4)
    for i, c in enumerate(cams):
        assert torch.equal(batch[i], pt.render_frame(scene, bvh, c, tex, bg, impl=impl,
                                                     shadows=shadows))
    plain = pt.render_frames(scene, bvh, pt.stack_cameras(cams), tex, bg,
                             impl=impl.replace("cuda", "plain"), shadows=shadows)
    assert torch.equal(plain, batch)


@pytest.mark.parametrize("impl", ["cuda4", "cuda2"])
def test_animated_renderer_on_the_card_equals_unfused(card, impl):
    scene = pt.build_scene(pt.terrain_mesh(res=32, size=16.0, amplitude=3.0, seed=1))
    bvh = pt.build_bvh(scene, builder="karras")
    cam = pt.make_camera(eye=(12, 10, 14), target=(0, 0, 0), width=64, height=64)
    t = scene.triangles
    base = torch.stack([t.a, t.b, t.c], dim=1)
    anim = pt.make_animated_renderer(scene, bvh, cam, impl=impl)
    wrapper = (trace_bvh4.traverse_bvh4 if impl == "cuda4" else trace_bvh2.traverse_bvh2)
    for phase in (0.3, 1.1):
        pos = base.clone()
        pos[..., 1] += 0.4 * torch.sin(base[..., 0] * 0.5 + phase)
        before = wrapper.launches
        got = anim(pos)
        assert wrapper.launches == before + 1
        s2 = pt.deform_scene(scene, pos)
        ref = pt.render_hits(s2, pt.refit_bvh(s2, bvh), cam, impl=impl)
        for f in ("t", "tri", "u", "v"):
            assert torch.equal(getattr(got, f), getattr(ref, f)), f
        assert bool(got.hit.any())


# ---- P1, P2: the probe kernels, and the SAH trees on the card ------------------
# Tolerance: bit-identical (integer-valued float32 tables, every sum below
# 2^24; vector_40ops is the same float32 operations, -fmad=false).


def _probe():
    from unitysimpleraytracing_tpu_torch.benchmarks import kernel_probe

    return kernel_probe


@pytest.mark.parametrize("iters", [0, 1, 333])
def test_probe_p1_bit_identical_to_plain(card, iters):
    kp = _probe()
    tab = kp.make_table(seed=4)
    for name in kp.P1_VARIANTS:
        before = kp.probe_kernel.launches
        got = kp.probe_kernel(name, tab, iters)
        torch.cuda.synchronize()
        assert kp.probe_kernel.launches == before + 1
        assert torch.equal(got, kp.run_probe_plain(name, tab, iters)), name


@pytest.mark.parametrize("neutral", [True, False])
@pytest.mark.parametrize("rows", [1 << 10, 1 << 15])
def test_probe_p2_bit_identical_to_plain(card, rows, neutral):
    kp = _probe()
    for depth, rpr in kp.P2_VARIANTS.values():
        table = kp.make_dma_table(seed=3, rows=rows, rows_per_rec=rpr, chain_neutral=neutral)
        before = kp.dma_probe_kernel.launches
        got = kp.dma_probe_kernel(table, depth, rpr, 96 // depth)
        torch.cuda.synchronize()
        assert kp.dma_probe_kernel.launches == before + 1
        assert torch.equal(got, kp.run_dma_probe_plain(table, depth, rpr, 96 // depth))
    with pytest.raises(ValueError, match="contiguous float32"):
        kp.dma_probe_kernel(table.double(), 1, 1, 4)


def test_probe_entry_point_on_the_card(card, capsys):
    import json

    kp = _probe()
    kp.probe_kernel.launches = kp.dma_probe_kernel.launches = 0
    lines = kp.main(["--iters", "2000"])
    printed = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert printed == lines
    names = [ln["probe"] for ln in lines]
    assert names[:len(kp.P1_VARIANTS)] == list(kp.P1_VARIANTS)
    assert all(n in names and n + "_devmem" in names for n in kp.P2_VARIANTS)
    assert kp.probe_kernel.launches > 0 and kp.dma_probe_kernel.launches > 0
    assert all(ln["device"] == torch.cuda.get_device_name(0) for ln in lines)
    by = {ln["probe"]: ln for ln in lines}
    assert by["empty"]["value"] == 2000.0 and by["reduce_sum_8x128"]["value"] == 2048000.0
    # A dependent fetch past L1 costs more than one through it.
    assert by["dep_fetch_l2_x1"]["ns_per_iter"] > by["dep_fetch_l1_x1"]["ns_per_iter"]


@pytest.mark.parametrize("builder", [None, "sah", "sah_free"])
def test_sah_trees_on_the_card(card, builder):
    """Built on the card: bit-identical to the CPU build; both kernels
    bit-identical to their plain versions on it; the frame under the parity
    contract against the Karras tree's."""
    import dataclasses

    mesh = pt.terrain_mesh(res=64, size=20.0, amplitude=4.0, seed=0)
    scene = pt.build_scene(mesh)
    bvh = pt.build_bvh(scene, builder=builder, diagnostics=True)
    on_cpu = pt.build_bvh(pt.build_scene(mesh, device="cpu"), builder=builder, diagnostics=True)
    for f in dataclasses.fields(bvh):
        g = getattr(bvh, f.name)
        if isinstance(g, torch.Tensor):
            assert torch.equal(g.cpu(), getattr(on_cpu, f.name)), f.name
    pt.build_bvh(scene, builder=builder, validate=True)
    o, d = _rays(10000, seed=3, bound=8.0, dev=card)
    for module, prepare in ((trace_bvh4, trace_bvh4.prepare_tables4),
                            (trace_bvh2, trace_bvh2.prepare_tables)):
        table = prepare(scene, bvh)
        kernel = module.traverse_bvh4 if module is trace_bvh4 else module.traverse_bvh2
        plain = module.traverse_bvh4_plain if module is trace_bvh4 else module.traverse_bvh2_plain
        assert_hit_parity(_np(kernel(table, o, d)), _np(plain(table, o, d)), exact=True)
    cam = pt.make_camera(eye=(15, 12, 18), target=(0, 0, 0), width=128, height=96)
    karras = pt.build_bvh(scene, builder="karras")
    assert_hit_parity(_np(pt.render_hits(scene, bvh, cam)), _np(pt.render_hits(scene, karras, cam)))
    tex = pt.solid_texture((0.8, 0.7, 0.6, 1.0))
    bg = np.asarray([0.1, 0.1, 0.12], np.float32)
    from unitysimpleraytracing_tpu_torch.utils.parity import compare_images, frame_to_uint8

    compare_images(
        frame_to_uint8(pt.frame_to_image(pt.render_frame(scene, bvh, cam, tex, bg, shadows=True))),
        frame_to_uint8(pt.frame_to_image(pt.render_frame(scene, karras, cam, tex, bg, shadows=True))),
        "SAH frame vs Karras frame")


def test_profiling_times_on_the_card(card):
    from unitysimpleraytracing_tpu_torch.utils import profiling

    x = torch.randn(1 << 22, device=card)
    s = profiling.measure(lambda: x * 2.0, iters=3, warmup=1, reps=4)
    assert 1e-6 < s < 1e-2
    got = profiling.measure_interleaved({"a": lambda: x * 2.0, "b": lambda: x + x}, iters=2)
    assert set(got) == {"a", "b"} and all(v[1] <= v[0] for v in got.values())
    prof = profiling.Profiler()
    with prof.op("mul", bytes_accessed=2 * x.numel() * 4):
        prof.sync(x * 2.0)
    assert 0 < prof.stats[0].roofline_fraction() < 1.5
    timer = profiling.Timer()
    assert timer.median_ms(lambda: x * 2.0, cold=True) > 0


# ---- K1c (compressed records) and the chunked path ---------------------------------


@pytest.mark.parametrize("scene_name", ["soup", "terrain"])
def test_compressed_kernel_bit_identical_to_plain(card, scene_name):
    """The 52-slot entry point against the plain 52-slot walk: t, tri, u, v
    and the records popped per ray, for nearest hit, any-hit, t_init and a
    ragged ray count; its launches are counted apart from K1's."""
    mesh = {
        "soup": lambda: pt.random_triangle_soup(3000, seed=7, bound=5.0, tri_size=1.0),
        "terrain": lambda: pt.terrain_mesh(res=64, size=20.0, amplitude=4.0, seed=0),
    }[scene_name]()
    scene = pt.build_scene(mesh)
    table = trace_bvh4.compress_tables4(trace_bvh4.prepare_tables4(scene, pt.build_bvh(scene)))
    assert table.shape[1] == 52
    o, d = _rays(10000, seed=3, bound=8.0, dev=card)
    thr = torch.full((10000,), 9.0, device=card)
    before = (trace_bvh4.traverse_bvh4.launches, trace_bvh4.traverse_bvh4.compressed_launches)
    for kw in ({}, {"anyhit_thresh": thr}):
        got, steps = trace_bvh4.traverse_bvh4(table, o, d, count_steps=True, **kw)
        want, wsteps = trace_bvh4.traverse_bvh4_plain(table, o, d, count_steps=True, **kw)
        _assert_same_bits(got, want)
        assert torch.equal(steps, wsteps)
    seed_t = torch.where(got.hit, got.t + 0.01, got.t)
    got = trace_bvh4.traverse_bvh4(table, o, d, t_init=seed_t)
    _assert_same_bits(got, trace_bvh4.traverse_bvh4_plain(table, o, d, t_init=seed_t))
    got = trace_bvh4.traverse_bvh4(table, o[:1001], d[:1001])
    _assert_same_bits(got, trace_bvh4.traverse_bvh4_plain(table, o[:1001], d[:1001]))
    torch.cuda.synchronize()
    assert trace_bvh4.traverse_bvh4.launches == before[0]
    assert trace_bvh4.traverse_bvh4.compressed_launches == before[1] + 4


@pytest.mark.parametrize("record_format", ["bvh4", "bvh2"])
def test_chunked_trace_on_the_card_equals_plain(card, record_format):
    """trace_chunked through the kernels (cuda4 / cuda2) against their plain
    versions over the same chunks, bit for bit, with routing, compaction and
    any-hit; one launch per chunk per call."""
    scene = pt.build_scene(pt.terrain_mesh(res=96, size=40.0, amplitude=6.0, seed=2))
    cbvh = pt.build_bvh_chunked(scene, chunk_capacity=4096, record_format=record_format)
    assert cbvh.num_chunks > 3
    kernel, plain = {"bvh4": ("cuda4", "plain4"), "bvh2": ("cuda2", "plain2")}[record_format]
    counter = trace_bvh4.traverse_bvh4 if record_format == "bvh4" else trace_bvh2.traverse_bvh2
    o, d = _rays(8000, seed=4, bound=30.0, dev=card)
    thr = torch.full((8000,), 25.0, device=card)
    for kw in ({"route": False}, {"route": True, "compact": 1}, {"anyhit_thresh": thr}):
        before = counter.launches
        got = pt.trace_chunked(cbvh, o, d, impl=kernel, **kw)
        torch.cuda.synchronize()
        assert counter.launches - before == cbvh.num_chunks
        _assert_same_bits(got, pt.trace_chunked(cbvh, o, d, impl=plain, **kw))
    cam = pt.make_camera(eye=(30, 25, 38), target=(0, 0, 0), width=128, height=96)
    tex = pt.solid_texture((0.9, 0.6, 0.3, 1.0))
    bg = np.asarray([0.1, 0.1, 0.12], np.float32)
    a = pt.render_frame_chunked(scene, cbvh, cam, tex, bg, shadows=True)
    b = pt.render_frame_chunked(scene, cbvh, cam, tex, bg, impl=plain, shadows=True)
    assert torch.equal(a, b)


# ---- the multi-device layer: K1 on every shard ------------------------------


@pytest.fixture(scope="module")
def nccl_mesh(card):
    """A one-process NCCL group, as ``make_mesh(1, 1)`` starts it."""
    import torch.distributed as tdist
    from unitysimpleraytracing_tpu_torch.parallel import dist

    mesh = dist.make_mesh(1, 1)
    assert tdist.get_backend() == "nccl"
    yield mesh
    tdist.destroy_process_group()


def _dist_setup(card):
    scene = pt.build_scene(pt.random_triangle_soup(3000, seed=7, bound=5.0, tri_size=1.0))
    bvh = pt.build_bvh(scene, builder="karras")
    o, d = _rays(4096, seed=3, bound=8.0, dev=card)
    return scene, bvh, o, d, dispatch.trace_rays(scene, bvh, o, d, impl="cuda4")


def _assert_exact_on_hits(got: dict, ref):
    """t bit for bit; tri, u, v on hits (a miss carries shard-local
    triangle 0): `benchmarks/dist_path.hold`, as chip_smoke.py holds them."""
    from unitysimpleraytracing_tpu_torch.benchmarks.dist_path import hold

    hold({f: got[f].cpu().numpy() for f in ("t", "tri", "u", "v")}, ref)


def _engine(dist, name, scene, bvh, mesh):
    """An engine as a function of the rays, returning its fields by name."""
    if name == "dp":
        def run(o, d):
            h = dist.render_hits_dp(scene, bvh, o, d, mesh)
            return {"t": h.t, "tri": h.tri, "u": h.u, "v": h.v}

        return run
    ss = dist.partition_scene(scene, 1)
    fn = getattr(dist, f"render_hits_{name}")
    return lambda o, d: dict(zip(("t", "tri", "u", "v", "uv", "normal"), fn(ss, o, d, mesh)))


_HOST_READS = {"dp": 0, "sharded": 1, "ring": 1, "shuffle": 2}


@pytest.mark.parametrize("name", sorted(_HOST_READS))
def test_dist_engines_at_world_size_one_on_nccl(card, nccl_mesh, name):
    """Each engine on a one-process NCCL group against trace_rays(impl=
    "cuda4") of the whole scene: one K1 launch, results on the card, the
    host reads the engine counts."""
    from unitysimpleraytracing_tpu_torch.parallel import dist

    scene, bvh, o, d, ref = _dist_setup(card)
    run = _engine(dist, name, scene, bvh, nccl_mesh)
    before = trace_bvh4.traverse_bvh4.launches
    nccl_mesh.host_reads = 0
    got = run(o, d)
    torch.cuda.synchronize()
    assert trace_bvh4.traverse_bvh4.launches == before + 1
    assert nccl_mesh.host_reads == _HOST_READS[name]
    assert all(x.device == nccl_mesh.device for x in got.values())
    _assert_exact_on_hits(got, ref)


@pytest.mark.parametrize("name", ["sharded", "ring", "shuffle"])
def test_nccl_engines_read_nothing_else_to_the_host(card, nccl_mesh, name):
    """No ray or payload leaves the card on the NCCL path: an engine call
    synchronises with the host no more often than its shard's own build and
    trace do, plus the host reads the engine counts (the shard's count, and
    the shuffle's sizes matrix)."""
    from unitysimpleraytracing_tpu_torch.benchmarks.dist_path import synchronising_calls
    from unitysimpleraytracing_tpu_torch.parallel import dist

    scene, bvh, o, d, _ref = _dist_setup(card)
    ss = dist.partition_scene(scene, 1)
    fields = dist._shard_fields(ss, 0)
    count = int(ss.counts[0])

    def shard_alone():
        scene_l = dist._shard_scene_view(fields, ss.shard_capacity)
        tree = dist._local_build(fields[11], fields[9], fields[10], count)
        dispatch.trace_rays(scene_l, tree, o, d)

    run = _engine(dist, name, scene, bvh, nccl_mesh)
    run(o, d)  # warm
    base = synchronising_calls(shard_alone)
    nccl_mesh.host_reads = 0
    calls = synchronising_calls(lambda: run(o, d))
    assert nccl_mesh.host_reads == _HOST_READS[name]
    assert calls <= base + _HOST_READS[name], (calls, base)


def test_ring_and_shuffle_on_two_gloo_ranks_on_one_card(card, tmp_path):
    """Two processes of one gloo group, every tensor on cuda:0 (NCCL refuses
    two ranks on one GPU): the ring and the shuffle at (1, 2) against
    trace_rays(impl="cuda4") of the whole scene; K1 on every shard (the ring
    traces twice a rank, the shuffle once)."""
    from _torch_dist_worker import assemble, rays, run_ranks

    trace_bvh4._load_kernel()  # built once, before the ranks start
    ranks = run_ranks("gpu_pair", 2, str(tmp_path))
    scene = pt.build_scene(pt.random_triangle_soup(300, seed=3, bound=5.0, tri_size=1.0))
    o, d = (x.to(card) for x in rays(512, seed=3))
    ref = dispatch.trace_rays(scene, pt.build_bvh(scene, builder="karras"), o, d, impl="cuda4")
    for name, launches, reads in (("ring", 2, 1), ("shuffle", 1, 2)):
        got = {k: torch.from_numpy(v) for k, v in assemble(ranks, name).items()}
        _assert_exact_on_hits(got, ref)
        for r in ranks:
            assert int(r[f"{name}_counts|k1_launches"]) == launches
            assert int(r[f"{name}_counts|host_reads"]) == reads


# ---- the host-side modules on the card ------------------------------------------


def test_device_healthcheck_on_the_card(card):
    from unitysimpleraytracing_tpu_torch.utils import resilience

    assert resilience.device_healthcheck() is True
    assert resilience.device_healthcheck(device="cuda") is True


def test_probe_kernel_on_a_k1_call(card):
    from unitysimpleraytracing_tpu_torch.utils import debug

    scene = pt.build_scene(pt.terrain_mesh(res=64, size=20.0, amplitude=4.0, seed=0))
    bvh = pt.build_bvh(scene)
    table = trace_bvh4.prepare_tables4(scene, bvh)
    o, d = _rays(4096, seed=5, bound=8.0, dev=card)
    before = trace_bvh4.traverse_bvh4.launches
    got = debug.probe_kernel(trace_bvh4.traverse_bvh4, table, o, d)
    assert trace_bvh4.traverse_bvh4.launches == before + 1
    want = trace_bvh4.traverse_bvh4(table, o, d)
    for f in ("t", "tri", "u", "v"):
        g = getattr(got, f)
        assert isinstance(g, np.ndarray) and g.tobytes() == getattr(want, f).cpu().numpy().tobytes()
    assert got.hit.any()


def test_cli_gizmo_on_the_card_equals_the_cpu_render_s_overlay(card, tmp_path):
    """The CLI's --gizmo --gizmo-tris render on the card and on the CPU: the
    overlay pixels are equal, the rest within tests/test_golden.py::_compare."""
    from unitysimpleraytracing_tpu_torch import cli
    from unitysimpleraytracing_tpu_torch.io.png import read_png
    from unitysimpleraytracing_tpu_torch.utils import visualize

    mesh = pt.terrain_mesh(res=24, size=20.0, amplitude=4.0, seed=0)
    obj = tmp_path / "t.obj"
    lines = [f"v {x!r} {y!r} {z!r}" for x, y, z in mesh.positions.reshape(-1, 3).tolist()]
    lines += [f"f {3*t+1} {3*t+2} {3*t+3}" for t in range(mesh.num_triangles)]
    obj.write_text("\n".join(lines) + "\n")
    W, H = 96, 64
    args = ["--width", str(W), "--height", str(H), "--shadows", "--gizmo", "--gizmo-tris"]
    cli.main([str(obj), str(tmp_path / "card.png"), *args])
    cli.main([str(obj), str(tmp_path / "cpu.png"), *args, "--device", "cpu"])
    got, want = read_png(str(tmp_path / "card.png")), read_png(str(tmp_path / "cpu.png"))
    m = pt.load_obj(str(obj))
    scene = pt.build_scene(m, device="cpu")
    bvh = pt.build_bvh(scene)
    lo, hi = m.positions.min(axis=(0, 1)), m.positions.max(axis=(0, 1))
    center = (lo + hi) / 2
    eye = center + np.array([0.8, 0.6, 1.2]) * float(np.linalg.norm(hi - lo))
    cam = pt.make_camera(eye=eye, target=center, width=W, height=H, device="cpu")
    over = np.zeros((H, W, 4), np.float32)
    over = visualize.draw_aabbs(over, cam, scene.aabb_min[: scene.count],
                                scene.aabb_max[: scene.count], color=(1.0, 1.0, 1.0))
    over = visualize.draw_aabbs(over, cam, bvh.node_aabb_min[: bvh.num_internal],
                                bvh.node_aabb_max[: bvh.num_internal], color=(1.0, 1.0, 1.0))
    mask = over[::-1, :, 0] == 1.0
    assert mask.sum() > 100
    assert np.array_equal(got[mask], want[mask])
    diff = np.abs(got[~mask].astype(np.int32) - want[~mask].astype(np.int32))
    assert float((diff > 2).mean()) < 0.002
