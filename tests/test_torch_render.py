"""Whole-slice parity of the PyTorch port: camera hits, frames against the
golden images and against the JAX package's frames, and the CLI."""
import os

import numpy as np
import pytest
import torch

import unitysimpleraytracing_tpu as rt
import unitysimpleraytracing_tpu_torch as pt
from unitysimpleraytracing_tpu_torch import cli as pcli
from unitysimpleraytracing_tpu_torch.io.png import read_png
from unitysimpleraytracing_tpu_torch.utils.parity import (
    assert_hit_parity, compare_images, frame_to_uint8, grazing_factor,
)

from _torch_common import CPU, n_

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _terrain16(m):
    return m.terrain_mesh(res=16, size=16.0, amplitude=3.0, seed=1)


@pytest.mark.parametrize("width,height", [(64, 64), (70, 50)])
def test_render_hits_vs_jax(width, height):
    """Both packages through their own generate_rays (last-ulp different
    directions), 32-divisible (tile-major) and not (row-major, padded).
    Contract: identical hit masks, t within 4e-6, tri flips only at ties,
    u, v within 1e-5 times the grazing factor."""
    js, ps = rt.build_scene(_terrain16(rt)), pt.build_scene(_terrain16(pt), device=CPU)
    jb = rt.build_bvh(js, builder="karras")
    pb = pt.build_bvh(ps, builder="karras")
    kw = dict(eye=(12.0, 10.0, 15.0), target=(0.0, 0.0, 0.0), width=width,
              height=height, fov_deg=60.0)
    jcam, pcam = rt.make_camera(**kw), pt.make_camera(**kw, device=CPU)
    want = rt.render_hits(js, jb, jcam, impl="perray")
    got = pt.render_hits(ps, pb, pcam)
    assert got.t.shape == (width * height,)
    from unitysimpleraytracing_tpu_torch.core.camera import generate_rays

    tri = ps.triangles
    scale = grazing_factor(n_(tri.a), n_(tri.b), n_(tri.c),
                           n_(generate_rays(pcam)[1]), np.asarray(want.tri))
    st = assert_hit_parity(got, want, uv_atol=1e-5, uv_scale=scale)
    assert 0.1 < st["hits"] / st["rays"] < 0.95
    # The port's oracle engine agrees with its BVH4 engine bit for bit.
    assert_hit_parity(got, pt.render_hits(ps, pb, pcam, impl="perray"), exact=True)


def _cube_frame(m, **kw):
    scene = m.build_scene(m.cube_mesh(size=2.0), **kw)
    bvh = m.build_bvh(scene, builder="karras")
    cam = m.make_camera(eye=(3, 2.5, 4), target=(0, 0, 0), width=128, height=96, **kw)
    tex = m.solid_texture((0.9, 0.6, 0.3, 1.0), **kw)
    bg = np.asarray([0.1, 0.1, 0.12], np.float32)
    return scene, bvh, cam, tex, bg


def _terrain_frame(m, **kw):
    scene = m.build_scene(m.terrain_mesh(res=48, size=40.0, amplitude=6.0, seed=0), **kw)
    bvh = m.build_bvh(scene, builder="karras")
    cam = m.make_camera(eye=(30, 25, 38), target=(0, 0, 0), width=128, height=96, **kw)
    tex = m.solid_texture((0.9, 0.6, 0.3, 1.0), **kw)
    bg = np.asarray([0.05, 0.05, 0.08], np.float32)
    return scene, bvh, cam, tex, bg


@pytest.fixture(scope="module")
def cube_frames():
    want = rt.render_frame(*_cube_frame(rt))
    got = pt.render_frame(*_cube_frame(pt, device=CPU))
    return got, want


@pytest.fixture(scope="module")
def terrain_frames():
    want = rt.render_frame(*_terrain_frame(rt), shadows=True)
    args = _terrain_frame(pt, device=CPU)
    got = pt.render_frame(*args, shadows=True)
    return got, want, args


def _golden(frame, name):
    """The goldens were rendered on the JAX default (sah_free) tree; hits are
    tree-independent up to ties.  ±2/255 on fewer than 0.2 % of values."""
    got = frame_to_uint8(pt.frame_to_image(frame))
    return compare_images(got, read_png(os.path.join(GOLDEN, name)), name)


def _vs_jax(got, want):
    """Within 1/255 on at least 99.8 % of the values."""
    g = frame_to_uint8(pt.frame_to_image(got))
    w = frame_to_uint8(rt.frame_to_image(want))
    compare_images(g, w, "frame vs JAX", tol=1, max_frac=0.002)


def test_golden_cube(cube_frames):
    got, _ = cube_frames
    assert tuple(got.shape) == (96, 128, 4) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all()) and bool((got[..., 3] == 1.0).all())
    _golden(got, "cube_128x96.png")


def test_cube_frame_vs_jax(cube_frames):
    _vs_jax(*cube_frames)


def test_golden_terrain_with_shadows(terrain_frames):
    _golden(terrain_frames[0], "terrain_shadow_128x96.png")


def test_terrain_shadow_frame_vs_jax(terrain_frames):
    _vs_jax(terrain_frames[0], terrain_frames[1])


def test_shadow_substitute_off_gives_identical_frame(terrain_frames):
    got, _, args = terrain_frames
    junk = pt.render_frame(*args, shadows=True, shadow_substitute=False)
    assert torch.equal(junk, got)
    # Shadows do change the frame, and only darken it.
    plain = pt.render_frame(*args)
    assert not torch.equal(plain, got)
    assert bool((got[..., :3] <= plain[..., :3]).all())


def test_render_rgba_alpha_is_hit_mask_and_background_plate(terrain_frames):
    _, _, (scene, bvh, cam, tex, bg) = terrain_frames
    rgba = pt.render_rgba(scene, bvh, cam, tex, shadows=True)
    hits = pt.render_hits(scene, bvh, cam)
    assert torch.equal(rgba[..., 3] == 1.0, hits.hit.reshape(96, 128))
    # An image background shows through exactly where nothing was hit.
    plate = np.random.default_rng(0).uniform(size=(96, 128, 3)).astype(np.float32)
    frame = pt.render_frame(scene, bvh, cam, tex, plate)
    miss = ~hits.hit.reshape(96, 128)
    assert torch.equal(frame[..., :3][miss], torch.from_numpy(plate)[miss])
    want = rt.render_frame(*_terrain_frame(rt)[:4], plate)
    _vs_jax(frame, want)


_OBJ = """v -1 0 -1
v 1 0 -1
v 1 0 1
v -1 0 1
v 0 1.5 0
vt 0 0
vt 1 0
vt 1 1
vt 0 1
f 1/1 2/2 3/3 4/4
f 1/1 2/2 5/3
f 2/1 3/2 5/3
f 3/1 4/2 5/3
f 4/1 1/2 5/3
"""


def test_cli_writes_png_on_cpu(tmp_path, capsys):
    obj = tmp_path / "pyramid.obj"
    obj.write_text(_OBJ)
    out = tmp_path / "out.png"
    pcli.main([str(obj), str(out), "--width", "96", "--height", "64", "--shadows",
               "--texture", os.path.join(GOLDEN, "cube_128x96.png"),
               "--device", "cpu"])
    img = read_png(str(out))
    assert img.shape == (64, 96, 4) and img.dtype == np.uint8
    assert len(np.unique(img.reshape(-1, 4), axis=0)) >= 4  # not a flat fill
    assert "6 triangles" in capsys.readouterr().out


def test_cli_orbit_subdivide_background_image(tmp_path):
    obj = tmp_path / "pyramid.obj"
    obj.write_text(_OBJ)
    out = tmp_path / "orbit.png"
    pcli.main([str(obj), str(out), "--width", "64", "--height", "32", "--orbit", "3",
               "--subdivide", "1", "--displace", "0.05", "--flip-x",
               "--background-image", os.path.join(GOLDEN, "cube_128x96.png"),
               "--device", "cpu"])
    frames = [read_png(str(tmp_path / f"orbit_{i:03d}.png")) for i in range(3)]
    assert all(f.shape == (32, 64, 4) for f in frames)
    assert not np.array_equal(frames[0], frames[1])


@pytest.mark.parametrize("builder", [[], ["--builder", "sah"], ["--builder", "karras"]])
def test_cli_builder_default_and_choices_vs_jax_cli(tmp_path, builder):
    """The two CLIs on the same OBJ with the same ``--builder`` (none = each
    package's default, the free-order SAH tree): PNGs within 1/255 on at least
    99.8 % of the values."""
    from unitysimpleraytracing_tpu import cli as jcli

    obj = tmp_path / "pyramid.obj"
    obj.write_text(_OBJ)
    common = [str(obj), "--width", "96", "--height", "64", "--shadows", "--subdivide", "2",
              "--texture", os.path.join(GOLDEN, "cube_128x96.png"), *builder]
    jcli.main([common[0], str(tmp_path / "jax.png"), *common[1:], "--platform", "cpu"])
    pcli.main([common[0], str(tmp_path / "port.png"), *common[1:], "--device", "cpu"])
    got, want = read_png(str(tmp_path / "port.png")), read_png(str(tmp_path / "jax.png"))
    assert got.shape == want.shape == (64, 96, 4)
    compare_images(got, want, "CLI PNG vs JAX CLI PNG", tol=1, max_frac=0.002)
    assert len(np.unique(got.reshape(-1, 4), axis=0)) >= 4  # not a flat fill


def test_cli_builder_choices_are_the_jax_cli_s(tmp_path, capsys):
    obj = tmp_path / "pyramid.obj"
    obj.write_text(_OBJ)
    with pytest.raises(SystemExit) as exc:
        pcli.main([str(obj), str(tmp_path / "o.png"), "--device", "cpu", "--builder", "binned"])
    assert exc.value.code != 0
    assert "karras, sah)" in capsys.readouterr().err.replace("'", "")


@pytest.mark.parametrize(
    "flag", [["--gizmo", "--gizmo-index", "3"], ["--gizmo-tris", "--gizmo-index", "0"],
             ["--gizmo"], ["--gizmo-tris"]])
def test_cli_unported_options_exit_with_message(tmp_path, capsys, flag):
    """The flags that once exited with a "not ported yet" message now render:
    the gizmo overlay (utils/visualize) changes the PNG and says nothing of
    being unported."""
    obj = tmp_path / "pyramid.obj"
    obj.write_text(_OBJ)
    pcli.main([str(obj), str(tmp_path / "plain.png"), "--device", "cpu",
               "--width", "64", "--height", "32"])
    pcli.main([str(obj), str(tmp_path / "o.png"), "--device", "cpu",
               "--width", "64", "--height", "32", *flag])
    out = capsys.readouterr()
    assert "not ported" not in out.out + out.err
    img, plain = read_png(str(tmp_path / "o.png")), read_png(str(tmp_path / "plain.png"))
    assert img.shape == plain.shape == (32, 64, 4)
    assert not np.array_equal(img, plain)
