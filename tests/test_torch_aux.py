"""The port's host-side helpers against the JAX package's, on the same seeded
numpy inputs: ``utils/reference_impl`` (the scalar oracle), ``utils/debug``,
``utils/resilience``, ``utils/visualize`` and the CLI's ``--gizmo*`` flags."""
import inspect
import os
import threading

import numpy as np
import pytest
import torch

import unitysimpleraytracing_tpu as rt
import unitysimpleraytracing_tpu_torch as pt
from unitysimpleraytracing_tpu.utils import debug as jdebug
from unitysimpleraytracing_tpu.utils import reference_impl as jref
from unitysimpleraytracing_tpu.utils import visualize as jvis
from unitysimpleraytracing_tpu_torch import cli as pcli
from unitysimpleraytracing_tpu_torch.io.png import read_png
from unitysimpleraytracing_tpu_torch.utils import debug as pdebug
from unitysimpleraytracing_tpu_torch.utils import reference_impl as pref
from unitysimpleraytracing_tpu_torch.utils import resilience as pres
from unitysimpleraytracing_tpu_torch.utils import visualize as pvis

from _torch_common import CPU, both_built, rays

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


# ---- utils/reference_impl: the port's copy of the scalar oracle -------------


@pytest.mark.parametrize("name", ["clz32", "karras_topology", "ray_box", "ray_triangle",
                                  "traverse_one_ray"])
def test_reference_impl_copy_has_the_same_code(name):
    assert inspect.getsource(getattr(pref, name)) == inspect.getsource(getattr(jref, name))
    assert pref.MAX_FLOAT == jref.MAX_FLOAT and pref.MAX_FLOAT.dtype == jref.MAX_FLOAT.dtype


def test_reference_impl_karras_topology_equal_on_64_morton_sets():
    rng = np.random.default_rng(0)
    for k in range(64):
        n = int(rng.integers(2, 96))
        bits = 30 if k % 2 else 8  # few bits: long shared prefixes
        # Distinct codes, as the build gives the oracle (ops/unique.distribute_keys).
        codes = np.sort(rng.choice(1 << bits, size=n, replace=False).astype(np.uint32))
        got, want = pref.karras_topology(codes, n), jref.karras_topology(codes, n)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    for v in [0, 1, 2, 3, 255, 1 << 20, (1 << 31) + 5, 0xFFFFFFFF]:
        assert pref.clz32(v) == jref.clz32(v)


def test_reference_impl_ray_box_and_triangle_equal_on_256_rays():
    o, d = rays(256, seed=11, bound=3.0)
    rng = np.random.default_rng(12)
    lo = rng.uniform(-2, 1, size=(256, 3)).astype(np.float32)
    hi = lo + rng.uniform(0, 2, size=(256, 3)).astype(np.float32)
    hi[::17, 1] = lo[::17, 1]  # flat boxes
    tri = rng.uniform(-2, 2, size=(256, 3, 3)).astype(np.float32)
    aim = (lo + hi)[::2] / 2 - o[::2]  # every other ray at its box's center
    d[::2] = aim / np.linalg.norm(aim, axis=1, keepdims=True)
    d[::31, 0] = 0.0  # axis-parallel rays: inf and NaN slabs
    with np.errstate(divide="ignore"):
        inv = np.float32(1.0) / d
    hits = 0
    for i in range(256):
        got = pref.ray_box(lo[i], hi[i], o[i], inv[i])
        assert got == jref.ray_box(lo[i], hi[i], o[i], inv[i])
        g = pref.ray_triangle(o[i], d[i], *tri[i])
        w = jref.ray_triangle(o[i], d[i], *tri[i])
        assert [np.float32(x).tobytes() for x in g] == [np.float32(x).tobytes() for x in w]
        hits += bool(got) + (g[0] != pref.MAX_FLOAT)
    assert hits > 20


def test_reference_impl_traverse_one_ray_equal_on_a_built_tree():
    js, jb, _, _ = both_built("soup97")
    arrs = [np.asarray(a) for a in (
        jb.node_aabb_min, jb.node_aabb_max, jb.left, jb.right, jb.left_is_leaf,
        jb.right_is_leaf, jb.sorted_tri, js.aabb_min, js.aabb_max, js.triangles.a,
        js.triangles.b, js.triangles.c)]
    o, d = rays(64, seed=3, bound=5.0)
    for i in range(64):
        g = pref.traverse_one_ray(o[i], d[i], *arrs)
        w = jref.traverse_one_ray(o[i], d[i], *arrs)
        assert [np.asarray(x).tobytes() for x in g] == [np.asarray(x).tobytes() for x in w]


# ---- utils/debug -----------------------------------------------------------------


@pytest.mark.parametrize("values, limit", [
    (np.arange(10, dtype=np.int32), 4096),
    (np.linspace(-1, 1, 7, dtype=np.float32).reshape(7, 1), 4096),
    (np.array([True, False, True]), 4096),
    (np.arange(5000, dtype=np.int64), 4096),       # past Utils.cs's cap: "…"
    (np.float32([0.1, 3.4028235e38, -0.0]), 2),
])
def test_array_to_string_and_dump_print_what_jax_prints(values, limit, capsys):
    want = jdebug.array_to_string(values, limit)
    assert pdebug.array_to_string(torch.from_numpy(values), limit) == want
    assert pdebug.array_to_string(values, limit) == want
    assert want.endswith(" …") == (values.size > limit)
    jdebug.dump("x", values, limit=limit)
    jax_out = capsys.readouterr().out
    pdebug.dump("x", torch.from_numpy(values), limit=limit)
    assert capsys.readouterr().out == jax_out


def test_probe_kernel_turns_a_hit_record_into_numpy_fields():
    _, _, ps, pb = both_built("cube")
    cam = pt.make_camera(eye=(3, 2.5, 4), target=(0, 0, 0), width=32, height=32, device=CPU)
    got = pdebug.probe_kernel(pt.render_hits, ps, pb, cam)
    want = pt.render_hits(ps, pb, cam)
    assert isinstance(got, pt.HitRecord)
    for f in ("t", "tri", "u", "v"):
        g = getattr(got, f)
        assert isinstance(g, np.ndarray) and g.tobytes() == getattr(want, f).numpy().tobytes()
    assert got.hit.any() and isinstance(got.hit, np.ndarray)
    nested = pdebug.probe_kernel(lambda: {"a": (torch.ones(2), [torch.zeros(1)]), "n": 3})
    assert isinstance(nested["a"][0], np.ndarray) and isinstance(nested["a"][1][0], np.ndarray)
    assert nested["n"] == 3 and isinstance(nested["n"], np.ndarray)  # as tree_map(np.asarray)
    bvh_np = pdebug.probe_kernel(lambda: pb)
    assert bvh_np.count == pb.count and isinstance(bvh_np.count, int)
    assert np.array_equal(bvh_np.left, pb.left.numpy())


# ---- utils/resilience: tests/test_resilience.py on the port, and CUDA wording ----


def test_healthcheck_on_cpu():
    assert pres.device_healthcheck(timeout_s=60.0, device="cpu")


def test_with_retry_recovers_from_transient():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("UNAVAILABLE: transport wedged")
        return 42

    seen = []
    out = pres.with_retry(flaky, retries=3, backoff_s=0.01,
                          on_retry=lambda i, e: seen.append(i))
    assert out == 42 and calls["n"] == 3 and seen == [0, 1]


def test_with_retry_propagates_non_transient():
    def broken():
        raise ValueError("shape mismatch")

    with pytest.raises(ValueError):
        pres.with_retry(broken, retries=5, backoff_s=0.01)


def test_with_retry_exhausts():
    def always():
        raise RuntimeError("DEADLINE_EXCEEDED: tunnel stall")

    with pytest.raises(RuntimeError):
        pres.with_retry(always, retries=1, backoff_s=0.01)


@pytest.mark.parametrize("message", [
    "DEADLINE_EXCEEDED: tunnel stall", "UNAVAILABLE: x", "ABORTED: y", "INTERNAL: z",
    "RESOURCE_EXHAUSTED: w",
    "CUDA out of memory. Tried to allocate 2.00 GiB",
    "CUDA error: CUDA-capable device(s) is/are busy or unavailable",
    "[Rank 0] Watchdog caught collective operation timeout: WorkNCCL(SeqNum=3, "
    "OpType=ALLREDUCE) ran for 600000 milliseconds before timing out.",
    "[gloo/transport/tcp/pair.cc:534] Timed out waiting 60000ms for recv operation to complete",
    "NCCL communicator was aborted on rank 1.",
    "NCCL error: internal error, ncclInternalError: Internal check failed.",
    "NCCL error: remote process exited or there was a network error, ncclRemoteError",
])
def test_transient_errors_keep_jax_markers_and_add_cuda_wording(message):
    assert pres.is_transient(RuntimeError(message))


@pytest.mark.parametrize("message", [
    "CUDA error: an illegal memory access was encountered",
    "CUDA error: unspecified launch failure",  # also a kernel's __trap() guard
    "CUDA error: an illegal instruction was encountered",
    "CUDA error: misaligned address",
    "CUDA error: device-side assert triggered",
    "CUDA error: the launch timed out and was terminated",
    "NCCL error: unhandled cuda error (run with NCCL_DEBUG=INFO): INTERNAL "
    "CUDA error: an illegal memory access was encountered",
    "INTERNAL ASSERT FAILED at aten/src/ATen/native/cuda/Indexing.cu:123",
    "shape mismatch",
])
def test_sticky_cuda_errors_are_not_transient(message):
    assert not pres.is_transient(RuntimeError(message))
    calls = {"n": 0}

    def sticky():
        calls["n"] += 1
        raise RuntimeError(message)

    with pytest.raises(RuntimeError):
        pres.with_retry(sticky, retries=3, backoff_s=0.01)
    assert calls["n"] == 1


def test_out_of_memory_error_type_is_transient():
    assert pres.is_transient(torch.OutOfMemoryError("allocation failed"))


def test_healthcheck_default_device_is_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device does not raise here")
    with pytest.raises(RuntimeError, match="CUDA"):
        pres.device_healthcheck()


def test_healthcheck_is_bounded_and_false_on_a_wedged_or_failing_device(monkeypatch):
    release = threading.Event()
    real_ones = torch.ones

    def wedged(*args, **kwargs):
        release.wait(30)
        return real_ones(*args, **kwargs)

    monkeypatch.setattr(torch, "ones", wedged)
    try:
        assert pres.device_healthcheck(timeout_s=0.2, device="cpu") is False
    finally:
        release.set()

    def failing(*args, **kwargs):
        raise RuntimeError("CUDA error: unspecified launch failure")

    monkeypatch.setattr(torch, "ones", failing)
    assert pres.device_healthcheck(timeout_s=10.0, device="cpu") is False


# ---- utils/visualize: bit-identical to the JAX package's ------------------------


def _cams(scene_name):
    kw = dict(target=(0, 0, 0), width=128, height=96)
    eye = {"cube": (3, 2.5, 4), "terrain48": (30, 25, 38)}[scene_name]
    return rt.make_camera(eye=eye, **kw), pt.make_camera(eye=eye, device=CPU, **kw)


@pytest.mark.parametrize("scene_name", ["cube", "terrain48"])
@pytest.mark.parametrize("boxes, max_boxes, index", [
    ("nodes", 4096, -1), ("tris", 4096, -1), ("nodes", 16, -1), ("tris", 4096, 5),
])
def test_draw_aabbs_bit_identical_to_jax(scene_name, boxes, max_boxes, index):
    js, jb, ps, pb = both_built(scene_name)
    jcam, pcam = _cams(scene_name)
    if boxes == "nodes":
        jmin, jmax = jb.node_aabb_min[: jb.num_internal], jb.node_aabb_max[: jb.num_internal]
        pmin, pmax = pb.node_aabb_min[: pb.num_internal], pb.node_aabb_max[: pb.num_internal]
    else:
        jmin, jmax = js.aabb_min[: js.count], js.aabb_max[: js.count]
        pmin, pmax = ps.aabb_min[: ps.count], ps.aabb_max[: ps.count]
    sel = slice(None) if index < 0 else slice(index, index + 1)
    jmin, jmax = np.asarray(jmin)[sel], np.asarray(jmax)[sel]
    pmin, pmax = pmin[sel], pmax[sel]
    assert pmin.numpy().tobytes() == jmin.tobytes() and pmax.numpy().tobytes() == jmax.tobytes()
    rng = np.random.default_rng(4)
    frame = rng.uniform(0, 1, size=(96, 128, 4)).astype(np.float32)
    want = jvis.draw_aabbs(frame, jcam, jmin, jmax, max_boxes=max_boxes)
    got = pvis.draw_aabbs(torch.from_numpy(frame), pcam, pmin, pmax, max_boxes=max_boxes)
    assert got.dtype == want.dtype == np.float32 and got.tobytes() == want.tobytes()
    assert np.count_nonzero(got != frame) > 0
    # numpy boxes and frame give the same pixels.
    assert pvis.draw_aabbs(frame, pcam, jmin, jmax, max_boxes=max_boxes).tobytes() == want.tobytes()


@pytest.mark.parametrize("scene_name", ["cube", "terrain48"])
def test_project_points_bit_identical_to_jax(scene_name):
    js, _, ps, _ = both_built(scene_name)
    jcam, pcam = _cams(scene_name)
    rng = np.random.default_rng(9)
    pts = np.concatenate([np.asarray(js.triangles.a)[: js.count],
                          rng.uniform(-60, 60, size=(512, 3)).astype(np.float32)])
    want = jvis.project_points(jcam, pts)
    for got in (pvis.project_points(pcam, pts), pvis.project_points(pcam, torch.from_numpy(pts))):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    assert want[2].any() and not want[2].all()


def test_aabb_overlay_draws_green_edges():
    mesh = pt.cube_mesh(size=2.0)
    scene = pt.build_scene(mesh, device=CPU)
    bvh = pt.build_bvh(scene)
    cam = pt.make_camera(eye=(3, 2.5, 4), target=(0, 0, 0), width=128, height=96, device=CPU)
    frame = np.zeros((96, 128, 4), np.float32)
    out = pvis.draw_aabbs(
        frame, cam,
        bvh.node_aabb_min[: bvh.num_internal],
        bvh.node_aabb_max[: bvh.num_internal],
    )
    assert frame.sum() == 0  # input not mutated
    green = (out[:, :, 1] == 1.0) & (out[:, :, 0] == 0.0)
    assert green.sum() > 50  # wireframe pixels present
    # Cube center projects inside the drawn bounding region.
    x, y, vis = pvis.project_points(cam, np.zeros((1, 3), np.float32))
    assert vis[0] and 0 < x[0] < 128 and 0 < y[0] < 96
    ys, xs = np.nonzero(green)
    assert xs.min() < x[0] < xs.max() and ys.min() < y[0] < ys.max()


def test_points_behind_camera_are_culled():
    cam = pt.make_camera(eye=(0, 0, 0), target=(0, 0, -1), width=64, height=64, device=CPU)
    pts = np.array([[0, 0, -5], [0, 0, 5]], np.float32)  # in front, behind
    _, _, vis = pvis.project_points(cam, pts)
    assert vis[0] and not vis[1]


# ---- the CLI's --gizmo flags against the JAX CLI's --------------------------------

_OBJ = """v -1 0 -1
v 1 0 -1
v 1 0 1
v -1 0 1
v 0 1.2 0
f 1 2 3 4
f 1 2 5
f 2 3 5
f 3 4 5
f 4 1 5
"""


def _gizmo_mask(width, height, scene, bvh, cam, index):
    """Pixels (top-down) the overlay draws: the same boxes over a zero frame
    (``bvh=None``: triangle boxes only)."""
    sel = slice(None) if index < 0 else slice(index, index + 1)
    over = np.zeros((height, width, 4), np.float32)
    over = pvis.draw_aabbs(over, cam, scene.aabb_min[: scene.count][sel],
                           scene.aabb_max[: scene.count][sel], color=(1.0, 1.0, 1.0))
    if bvh is not None:
        over = pvis.draw_aabbs(over, cam, bvh.node_aabb_min[: bvh.num_internal][sel],
                               bvh.node_aabb_max[: bvh.num_internal][sel], color=(1.0, 1.0, 1.0))
    return over[::-1, :, 0] == 1.0


# The internal nodes are compared on the Karras tree, which the two packages
# build bit for bit; their free-order SAH trees may flip near-equal splits
# (tests/test_torch_sah.py), so on the default tree only the triangles' boxes
# are drawn by both.
@pytest.mark.parametrize("builder, flags, index", [
    (["--builder", "karras"], ["--gizmo", "--gizmo-tris"], -1),
    (["--builder", "karras"], ["--gizmo", "--gizmo-tris"], 2),
    ([], ["--gizmo-tris"], -1),
])
def test_cli_gizmo_pixels_equal_the_jax_cli_s(tmp_path, builder, flags, index):
    from unitysimpleraytracing_tpu import cli as jcli

    obj = tmp_path / "pyramid.obj"
    obj.write_text(_OBJ)
    W, H = 64, 48
    common = ["--width", str(W), "--height", str(H), "--subdivide", "1", *builder]
    gizmo = [*flags, "--gizmo-index", str(index)]
    jcli.main([str(obj), str(tmp_path / "jax.png"), *common, *gizmo, "--platform", "cpu"])
    pcli.main([str(obj), str(tmp_path / "port.png"), *common, *gizmo, "--device", "cpu"])
    got, want = read_png(str(tmp_path / "port.png")), read_png(str(tmp_path / "jax.png"))
    assert got.shape == want.shape == (H, W, 4)
    # The port CLI's scene, tree and camera, built as it builds them.
    mesh = pt.subdivide_mesh(pt.load_obj(str(obj)), levels=1)
    scene = pt.build_scene(mesh, device=CPU)
    bvh = pt.build_bvh(scene, builder=builder[1] if builder else None)
    lo, hi = mesh.positions.min(axis=(0, 1)), mesh.positions.max(axis=(0, 1))
    center = (lo + hi) / 2
    eye = center + np.array([0.8, 0.6, 1.2]) * float(np.linalg.norm(hi - lo))
    cam = pt.make_camera(eye=eye, target=center, width=W, height=H, device=CPU)
    mask = _gizmo_mask(W, H, scene, bvh if "--gizmo" in flags else None, cam, index)
    assert mask.sum() > (20 if index >= 0 else 200)
    assert np.array_equal(got[mask], want[mask])  # the gizmo pixels, exactly
    rgb = got[..., :3].reshape(-1, 3)
    assert ((rgb == (255, 255, 255)).all(axis=1)).any()
    assert ((rgb == (255, 0, 0)).all(axis=1)).any() == ("--gizmo" in flags)
    # Every other pixel as tests/test_golden.py::_compare holds a frame.
    diff = np.abs(got[~mask].astype(np.int32) - want[~mask].astype(np.int32))
    assert float((diff > 2).mean()) < 0.002
    # Without the flags the same run draws nothing over the frame.
    pcli.main([str(obj), str(tmp_path / "plain.png"), *common, "--device", "cpu"])
    plain = read_png(str(tmp_path / "plain.png"))
    assert np.array_equal(plain[~mask], got[~mask]) and not np.array_equal(plain, got)
