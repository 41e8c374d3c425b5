"""The animated (refit-per-frame) renderer of the PyTorch port, the new
engines in dispatch and registry, and the CLI's ``--orbit-batch``.

`make_animated_renderer` against the unfused deform → refit → `render_hits`
sequence inside the port: bit-identical (both run the same eager code).
Against the JAX package's `make_animated_renderer` on the same numpy
positions: the hit contract of tests/test_dynamic.py — identical hit masks, t
within rtol=4e-6, triangle ids identical on hits except exact-t ties.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unitysimpleraytracing_tpu as rt
import unitysimpleraytracing_tpu_torch as pt
from unitysimpleraytracing_tpu_torch import cli as pcli
from unitysimpleraytracing_tpu_torch.io import convert
from unitysimpleraytracing_tpu_torch.io.png import read_png
from unitysimpleraytracing_tpu_torch.ops import dispatch as pdispatch
from unitysimpleraytracing_tpu_torch.ops import registry, trace_bvh2, trace_bvh4, trace_packet
from unitysimpleraytracing_tpu_torch.utils.parity import assert_hit_parity

from _torch_common import CPU, n_

_PHASES = (0.3, 1.1)
_FIELDS = ("t", "tri", "u", "v")


def _setup(m, **kw):
    scene = m.build_scene(m.terrain_mesh(res=16, size=16.0, amplitude=3.0, seed=1), **kw)
    bvh = m.build_bvh(scene, builder="karras")
    cam = m.make_camera(eye=(12, 10, 14), target=(0, 0, 0), width=64, height=64, **kw)
    return scene, bvh, cam


def _positions(scene, phase):
    """The deformation of tests/test_dynamic.py, made with numpy so both
    packages get the same (T, 3, 3) float32 array."""
    t = scene.triangles
    base = np.stack([n_(t.a), n_(t.b), n_(t.c)], axis=1)
    pos = base.copy()
    pos[..., 1] += (np.float32(0.4) * np.sin(base[..., 0] * np.float32(0.5)
                                             + np.float32(phase))).astype(np.float32)
    return pos.astype(np.float32)


@pytest.fixture(scope="module")
def port():
    return _setup(pt, device=CPU)


@pytest.fixture(scope="module")
def jax_animated():
    """The JAX package's animated frames (its CPU engine) for both phases."""
    scene, bvh, cam = _setup(rt)
    anim = rt.make_animated_renderer(scene, bvh, cam)
    return {ph: anim(jnp.asarray(_positions(scene, ph))) for ph in _PHASES}


@pytest.mark.parametrize("impl", ["plain4", "plain2", "packet", "perray"])
def test_animated_bit_identical_to_unfused(port, impl):
    scene, bvh, cam = port
    anim = pt.make_animated_renderer(scene, bvh, cam, impl=impl)
    static = pt.render_hits(scene, bvh, cam, impl=impl)
    for ph in _PHASES:
        pos = convert.positions_from_numpy(_positions(scene, ph), device=CPU)
        got = anim(pos)
        s2 = pt.deform_scene(scene, pos)
        b2 = pt.refit_bvh(s2, bvh)
        ref = pt.render_hits(s2, b2, cam, impl=impl)
        for f in _FIELDS:
            assert torch.equal(getattr(got, f), getattr(ref, f)), (ph, f)
        assert bool(got.hit.any()) and not torch.equal(got.t, static.t)
    # The renderer closes over the ORIGINAL scene: a second pass over the
    # first phase gives the first answer again.
    again = anim(convert.positions_from_numpy(_positions(scene, _PHASES[0]), device=CPU))
    s2 = pt.deform_scene(scene, convert.positions_from_numpy(
        _positions(scene, _PHASES[0]), device=CPU))
    assert torch.equal(again.t, pt.render_hits(s2, pt.refit_bvh(s2, bvh), cam, impl=impl).t)


@pytest.mark.parametrize("impl", ["plain4", "plain2"])
def test_animated_vs_jax(port, jax_animated, impl):
    scene, bvh, cam = port
    anim = pt.make_animated_renderer(scene, bvh, cam, impl=impl)
    for ph in _PHASES:
        got = anim(convert.positions_from_numpy(_positions(scene, ph), device=CPU))
        st = assert_hit_parity(got, jax_animated[ph])
        assert 0.1 < st["hits"] / st["rays"] < 0.95


def test_animated_plan_is_computed_once_and_table_matches_a_fresh_pack(port):
    scene, bvh, cam = port
    pos = convert.positions_from_numpy(_positions(scene, 0.3), device=CPU)
    s2 = pt.deform_scene(scene, pos)
    b2 = pt.refit_bvh(s2, bvh)
    # BVH4: the plan made once from the original tree, applied to the
    # refitted geometry, is the table a fresh pack of the refitted tree gives.
    mask, new_id, cap4 = trace_bvh4._node_mask_cached(bvh)
    plan = trace_bvh4._pack_plan4(bvh, mask, new_id, max(cap4, 1))
    assert torch.equal(trace_bvh4._apply_plan4(s2, b2, *plan), trace_bvh4.prepare_tables4(s2, b2))
    assert b2.left is bvh.left  # refit keeps the topology tensors
    # Binary records: boxes and vertices move, metas do not.
    t0, t1 = trace_bvh2.pack_tables(scene, bvh), trace_bvh2.pack_tables(s2, b2)
    assert torch.equal(t0[:, 12:14], t1[:, 12:14]) and not torch.equal(t0[:, :12], t1[:, :12])
    with pytest.raises(ValueError, match="positions"):
        convert.positions_from_numpy(np.zeros((4, 3), np.float32), device=CPU)


def test_dispatch_and_registry_know_the_new_engines(port):
    scene, bvh, cam = port
    assert registry.engines("traverse") == [
        "cuda2", "cuda4", "packet", "perray", "plain2", "plain4"]
    assert registry.get("traverse", "packet") is trace_packet.traverse_packets
    assert registry.get("traverse", "plain2") is trace_bvh2.traverse_bvh2_plain
    assert registry.get("traverse", "cuda2") is trace_bvh2.traverse_bvh2
    for impl in ("cuda2", "plain2", "packet", "perray", "cuda4", "plain4"):
        assert pdispatch.resolve_impl(impl, bvh.capacity, "cpu") == impl
    assert pdispatch.resolve_impl("auto", bvh.capacity, "cpu") == "plain4"
    assert pdispatch.resolve_impl("auto", bvh.capacity, "cuda") == "cuda4"
    want = pt.render_hits(scene, bvh, cam, impl="perray")
    for impl in ("plain2", "packet", "cuda2"):  # cuda2 on CPU tensors: its plain version
        got = pt.render_hits(scene, bvh, cam, impl=impl)
        assert_hit_parity(got, want, exact=True)
    assert trace_bvh2.traverse_bvh2.launches == 0
    with pytest.raises(ValueError, match="unknown traversal impl"):
        pt.render_hits(scene, bvh, cam, impl="pallas")


def test_plain2_raises_capacity_error_at_two_to_the_twenty(port):
    scene, bvh, cam = port
    big = bvh.replace(left=torch.zeros(1 << 20, dtype=bvh.left.dtype))
    assert big.capacity == 1 << 20
    for impl in ("plain2", "cuda2"):
        with pytest.raises(pdispatch.CapacityError, match="cuda4"):
            pt.render_hits(scene, big, cam, impl=impl)
        with pytest.raises(pdispatch.CapacityError, match="2\\^?20|20-bit"):
            pt.make_animated_renderer(scene, big, cam, impl=impl)
    with pytest.raises(ValueError, match="2\\^20"):
        trace_bvh2.pack_tables(scene, big)


_OBJ = """v -1 0 -1
v 1 0 -1
v 1 0 1
v -1 0 1
v 0 1.5 0
f 1 2 3 4
f 1 2 5
f 2 3 5
f 3 4 5
f 4 1 5
"""


@pytest.mark.parametrize("extra", [[], ["--shadows"]])
def test_cli_orbit_batch_writes_the_same_png_bytes(tmp_path, capsys, extra):
    obj = tmp_path / "pyramid.obj"
    obj.write_text(_OBJ)
    common = ["--width", "64", "--height", "32", "--orbit", "3", "--device", "cpu", *extra]
    pcli.main([str(obj), str(tmp_path / "a.png"), *common])
    pcli.main([str(obj), str(tmp_path / "b.png"), *common, "--orbit-batch"])
    out = capsys.readouterr().out
    assert "orbit-batch: single group" in out and "steady" in out
    for i in range(3):
        a = (tmp_path / f"a_{i:03d}.png").read_bytes()
        assert a == (tmp_path / f"b_{i:03d}.png").read_bytes(), f"frame {i}"
    img = read_png(str(tmp_path / "b_001.png"))
    assert img.shape == (32, 64, 4)
    # Not a flat fill (the OBJ has no normals: hits shade at the ambient floor).
    assert len(np.unique(img.reshape(-1, 4), axis=0)) >= 2


def test_cli_orbit_batch_falls_back_on_odd_dims(tmp_path, capsys):
    obj = tmp_path / "pyramid.obj"
    obj.write_text(_OBJ)
    pcli.main([str(obj), str(tmp_path / "c.png"), "--width", "70", "--height", "32",
               "--orbit", "2", "--device", "cpu", "--orbit-batch"])
    out = capsys.readouterr().out
    assert "orbit-batch needs 32-divisible dims; falling back to the per-frame loop" in out
    assert read_png(str(tmp_path / "c_001.png")).shape == (32, 70, 4)


def test_cli_orbit_batch_groups_frames(tmp_path, capsys, monkeypatch):
    """A group holds 2**22 // (W*H) frames: five 64x32 frames are ONE
    `render_frames` call over five stacked cameras, and five PNGs."""
    obj = tmp_path / "pyramid.obj"
    obj.write_text(_OBJ)
    calls = []
    real = pt.render_frames

    def counting(scene, bvh, cams, *a, **kw):
        calls.append(int(cams.cam_to_world.shape[0]))
        return real(scene, bvh, cams, *a, **kw)

    monkeypatch.setattr(pt, "render_frames", counting)
    pcli.main([str(obj), str(tmp_path / "g.png"), "--width", "64", "--height", "32",
               "--orbit", "5", "--device", "cpu", "--orbit-batch"])
    assert calls == [5]
    assert all((tmp_path / f"g_{i:03d}.png").exists() for i in range(5))
    assert "wrote" in capsys.readouterr().out
