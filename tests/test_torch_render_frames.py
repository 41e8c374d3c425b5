"""Batched frames of the PyTorch port (`pipeline/render.render_frames`).

The batched path flattens F frames into one ray batch; within the port it
must be bit-identical to F independent `render_frame` calls (the cases of
tests/test_render_frames.py: shadows off and on, image background), for every
engine the CPU runs.  Against the JAX package's `render_frames` the frames
are held to the golden tolerance of `utils/parity.compare_images`: ±2/255 on
at most 0.2 % of the values.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unitysimpleraytracing_tpu as rt
import unitysimpleraytracing_tpu_torch as pt
from unitysimpleraytracing_tpu_torch.core.camera import generate_rays
from unitysimpleraytracing_tpu_torch.io import convert
from unitysimpleraytracing_tpu_torch.utils.parity import compare_images, frame_to_uint8

from _torch_common import CPU, assert_same_bits

_ANGLES = (0.1, 1.3, 2.9)
_BG = np.asarray([0.1, 0.1, 0.12], np.float32)


def _setup(m, **kw):
    scene = m.build_scene(m.terrain_mesh(res=12, size=8.0, amplitude=1.5, seed=0), **kw)
    bvh = m.build_bvh(scene, builder="karras")
    tex = m.solid_texture((0.8, 0.7, 0.6, 1.0), **kw)
    cams = [
        m.make_camera(eye=(5 * np.cos(a), 4.0, 5 * np.sin(a)), target=(0.0, 0.0, 0.0),
                      width=64, height=64, **kw)
        for a in _ANGLES
    ]
    return scene, bvh, tex, cams


@pytest.fixture(scope="module")
def port():
    scene, bvh, tex, cams = _setup(pt, device=CPU)
    return scene, bvh, tex, cams, pt.stack_cameras(cams)


@pytest.fixture(scope="module")
def jax_frames():
    """The JAX package's batched frames: shadows off, on, and over a plate."""
    scene, bvh, tex, cams = _setup(rt)
    stack = jax.tree.map(lambda *xs: jnp.stack(xs), *cams)
    plate = np.random.default_rng(3).uniform(size=(64, 64, 3)).astype(np.float32)
    return {
        "stack": stack,
        False: np.asarray(rt.render_frames(scene, bvh, stack, tex, jnp.asarray(_BG))),
        True: np.asarray(
            rt.render_frames(scene, bvh, stack, tex, jnp.asarray(_BG), shadows=True)),
        "plate": np.asarray(rt.render_frames(scene, bvh, stack, tex, jnp.asarray(plate))),
    }


def test_stack_cameras_round_trip(port, jax_frames):
    _, _, _, cams, stack = port
    assert tuple(stack.cam_to_world.shape) == (3, 4, 4)
    assert tuple(stack.tan_half_fov.shape) == (3,) and tuple(stack.near.shape) == (3,)
    assert (stack.width, stack.height) == (64, 64)
    for i, c in enumerate(cams):
        assert torch.equal(stack.cam_to_world[i], c.cam_to_world)
        assert torch.equal(stack.near[i], c.near)
    # Stacked rays: frame f bit-identical to camera f's own rays.
    o, d = generate_rays(stack)
    assert tuple(o.shape) == tuple(d.shape) == (3, 64 * 64, 3)
    for i, c in enumerate(cams):
        oi, di = generate_rays(c)
        assert torch.equal(o[i], oi) and torch.equal(d[i], di)
    # The JAX package's stacked camera carried across is the same stack.
    carried = convert.camera_from_numpy(jax_frames["stack"], device=CPU)
    assert_same_bits(carried.cam_to_world, stack.cam_to_world, "cam_to_world")
    assert_same_bits(carried.tan_half_fov, stack.tan_half_fov, "tan_half_fov")
    co, cd = generate_rays(carried)
    assert torch.equal(co, o) and torch.equal(cd, d)
    back = convert.to_numpy(stack)
    np.testing.assert_array_equal(back["cam_to_world"], np.asarray(jax_frames["stack"].cam_to_world))
    with pytest.raises(ValueError, match="one resolution"):
        pt.stack_cameras([cams[0], pt.make_camera(
            eye=(1, 1, 1), target=(0, 0, 0), width=32, height=64, device=CPU)])
    with pytest.raises(ValueError, match="no cameras"):
        pt.stack_cameras([])


@pytest.mark.parametrize("impl", ["plain4", "plain2", "packet"])
@pytest.mark.parametrize("shadows", [False, True])
def test_batched_frames_bit_identical(port, impl, shadows):
    scene, bvh, tex, cams, stack = port
    batched = pt.render_frames(scene, bvh, stack, tex, _BG, impl=impl, shadows=shadows)
    assert tuple(batched.shape) == (len(cams), 64, 64, 4)
    assert batched.dtype == torch.float32 and bool(torch.isfinite(batched).all())
    for i, c in enumerate(cams):
        single = pt.render_frame(scene, bvh, c, tex, _BG, impl=impl, shadows=shadows)
        assert torch.equal(batched[i], single), f"frame {i}"
    assert not torch.equal(batched[0], batched[1])


@pytest.mark.parametrize("impl", ["plain4", "plain2", "packet"])
def test_batched_frames_background_image(port, impl):
    scene, bvh, tex, cams, stack = port
    plate = np.random.default_rng(3).uniform(size=(64, 64, 3)).astype(np.float32)
    batched = pt.render_frames(scene, bvh, stack, tex, plate, impl=impl)
    single = pt.render_frame(scene, bvh, cams[1], tex, plate, impl=impl)
    assert torch.equal(batched[1], single)
    # The plate shows through exactly where nothing was hit.
    miss = ~pt.render_hits(scene, bvh, cams[1], impl=impl).hit.reshape(64, 64)
    assert bool(miss.any())
    assert torch.equal(batched[1][..., :3][miss], torch.from_numpy(plate)[miss])


@pytest.mark.parametrize("case", [False, True, "plate"])
def test_batched_frames_vs_jax(port, jax_frames, case):
    scene, bvh, tex, _, stack = port
    if case == "plate":
        plate = np.random.default_rng(3).uniform(size=(64, 64, 3)).astype(np.float32)
        got = pt.render_frames(scene, bvh, stack, tex, plate)
    else:
        got = pt.render_frames(scene, bvh, stack, tex, _BG, shadows=case)
    want = jax_frames[case]
    assert tuple(got.shape) == want.shape
    for i in range(len(_ANGLES)):
        compare_images(
            frame_to_uint8(pt.frame_to_image(got[i])), frame_to_uint8(want[i][::-1]),
            f"frame {i}")


def test_auto_on_the_cpu_is_plain4_and_engines_agree(port):
    scene, bvh, tex, _, stack = port
    auto = pt.render_frames(scene, bvh, stack, tex, _BG, shadows=True)
    assert torch.equal(auto, pt.render_frames(scene, bvh, stack, tex, _BG, impl="plain4",
                                              shadows=True))
    # No exact-t tie in these frames: every engine gives the same pixels.
    for impl in ("plain2", "packet", "perray"):
        other = pt.render_frames(scene, bvh, stack, tex, _BG, impl=impl, shadows=True)
        assert torch.equal(other, auto), impl


def test_render_frames_rejects_what_it_does_not_take(port):
    scene, bvh, tex, cams, _ = port
    with pytest.raises(ValueError, match="stacked"):
        pt.render_frames(scene, bvh, cams[0], tex, _BG)
    odd = pt.stack_cameras([pt.make_camera(
        eye=(5, 4, 1), target=(0, 0, 0), width=70, height=64, device=CPU)])
    with pytest.raises(ValueError, match="32-divisible"):
        pt.render_frames(scene, bvh, odd, tex, _BG)
