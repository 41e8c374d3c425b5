"""Camera-ray and texture parity of the PyTorch port against the JAX package."""
import os

import numpy as np
import pytest
import torch

import unitysimpleraytracing_tpu as rt
import unitysimpleraytracing_tpu_torch as pt
from unitysimpleraytracing_tpu.core import camera as jcamera
from unitysimpleraytracing_tpu.core import texture as jtexture
from unitysimpleraytracing_tpu_torch.core import camera as pcamera
from unitysimpleraytracing_tpu_torch.core import texture as ptexture
from unitysimpleraytracing_tpu_torch.io import convert

from _torch_common import CPU, assert_same_bits, n_

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

_CAMERAS = {
    "cube_128x96": dict(eye=(3, 2.5, 4), target=(0, 0, 0), width=128, height=96),
    "terrain_64x64": dict(
        eye=(12.0, 10.0, 15.0), target=(0.0, 0.0, 0.0), width=64, height=64, fov_deg=60.0
    ),
    "odd_70x50_fov35": dict(
        eye=(-7.0, 3.0, 2.0), target=(1.0, 0.5, -2.0), width=70, height=50,
        fov_deg=35.0, near=0.1,
    ),
    "down_axis": dict(eye=(0.0, 0.0, 15.7), target=(0.0, 0.0, 0.0), width=96, height=32),
}


def test_look_at_bit_identical():
    for kw in _CAMERAS.values():
        got = pcamera.look_at(kw["eye"], kw["target"])
        want = jcamera.look_at(kw["eye"], kw["target"])
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("name", sorted(_CAMERAS))
def test_make_camera_fields_bit_identical(name):
    jc = rt.make_camera(**_CAMERAS[name])
    pc = pt.make_camera(**_CAMERAS[name], device=CPU)
    assert (pc.width, pc.height) == (jc.width, jc.height)
    for f in ("cam_to_world", "tan_half_fov", "near"):
        assert_same_bits(getattr(pc, f), getattr(jc, f), f)


@pytest.mark.parametrize("name", sorted(_CAMERAS))
def test_generate_rays_parity(name):
    """Within rtol=2e-6: XLA:CPU may fuse a multiply-add that eager PyTorch
    keeps apart, a last-ULP difference; origins are exact."""
    jo, jd = jcamera.generate_rays(rt.make_camera(**_CAMERAS[name]))
    po, pd = pcamera.generate_rays(pt.make_camera(**_CAMERAS[name], device=CPU))
    assert_same_bits(po, jo, "origins")
    assert pd.shape == jd.shape and pd.dtype == torch.float32 and pd.is_contiguous()
    np.testing.assert_allclose(n_(pd), n_(jd), rtol=2e-6, atol=1e-7)
    np.testing.assert_allclose(np.linalg.norm(n_(pd), axis=1), 1.0, rtol=1e-6)


def test_camera_carried_across_gives_same_rays():
    jc = rt.make_camera(**_CAMERAS["odd_70x50_fov35"])
    pc = convert.camera_from_numpy(jc, device=CPU)
    want = pcamera.generate_rays(pt.make_camera(**_CAMERAS["odd_70x50_fov35"], device=CPU))
    got = pcamera.generate_rays(pc)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _image(h, w, c, seed, dtype):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        shape = (h, w) if c == 0 else (h, w, c)
        return rng.integers(0, 256, size=shape, dtype=np.uint8)
    return rng.uniform(0, 1, size=(h, w, c)).astype(np.float32)


@pytest.mark.parametrize("srgb", [False, True])
@pytest.mark.parametrize(
    "c,dtype", [(0, np.uint8), (1, np.uint8), (3, np.uint8), (4, np.uint8), (3, np.float32)]
)
def test_texture_from_array_bit_identical(c, dtype, srgb):
    img = _image(13, 17, c, seed=c + 1, dtype=dtype)
    want = jtexture.texture_from_array(img, srgb=srgb)
    got = ptexture.texture_from_array(img, srgb=srgb, device=CPU)
    assert (got.height, got.width) == (want.height, want.width) == (13, 17)
    assert_same_bits(got.data, want.data, "texture data")


def test_solid_and_loaded_textures_bit_identical():
    assert_same_bits(
        pt.solid_texture((0.9, 0.6, 0.3, 1.0), device=CPU).data,
        rt.solid_texture((0.9, 0.6, 0.3, 1.0)).data,
    )
    path = os.path.join(GOLDEN, "cube_128x96.png")
    for srgb in (False, True):
        assert_same_bits(
            pt.load_texture(path, srgb=srgb, device=CPU).data,
            rt.load_texture(path, srgb=srgb).data,
        )


def _uv_cases(w, h):
    rng = np.random.default_rng(8)
    u = rng.uniform(-0.25, 1.25, size=4096).astype(np.float32)
    v = rng.uniform(-0.25, 1.25, size=4096).astype(np.float32)
    # Hand-made: below edge, above edge, exact texel centres, exact edges.
    special_u = [-0.5, -1e-3, 0.0, 0.5 / w, 1.5 / w, (w - 0.5) / w, 1.0, 1.0 + 1e-3, 2.0, 0.5]
    special_v = [-0.5, 0.0, 0.5 / h, (h - 1.5) / h, (h - 0.5) / h, 1.0, 1.5, 0.25, 0.5, 0.75]
    su, sv = np.meshgrid(np.float32(special_u), np.float32(special_v))
    return np.concatenate([u, su.ravel()]), np.concatenate([v, sv.ravel()])


@pytest.mark.parametrize("h,w", [(8, 8), (13, 17), (1, 5), (2, 2)])
def test_sample_bilinear_parity(h, w):
    """rtol=1e-6, atol=1e-7: the lerps may be fused differently by XLA."""
    img = _image(h, w, 4, seed=h * w, dtype=np.float32)
    jt = jtexture.texture_from_array(img)
    ptx = ptexture.texture_from_array(img, device=CPU)
    u, v = _uv_cases(w, h)
    want = np.asarray(jtexture.sample_bilinear(jt, u, v))
    got = n_(ptexture.sample_bilinear(ptx, torch.from_numpy(u), torch.from_numpy(v)))
    assert got.shape == want.shape == (u.shape[0], 4)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_sample_bilinear_texel_centres_exact():
    """At texel centres the sample IS the texel; below/above the edge it is
    the edge texel (clamp addressing)."""
    img = _image(6, 5, 4, seed=3, dtype=np.float32)
    tex = ptexture.texture_from_array(img, device=CPU)
    ys, xs = np.meshgrid(np.arange(6), np.arange(5), indexing="ij")
    u = torch.from_numpy(((xs.ravel() + 0.5) / 5).astype(np.float32))
    v = torch.from_numpy(((ys.ravel() + 0.5) / 6).astype(np.float32))
    got = n_(ptexture.sample_bilinear(tex, u, v)).reshape(6, 5, 4)
    np.testing.assert_allclose(got, n_(tex.data), rtol=1e-6, atol=1e-7)
    out = n_(ptexture.sample_bilinear(
        tex, torch.tensor([-3.0, 4.0]), torch.tensor([-3.0, 4.0])))
    np.testing.assert_array_equal(out[0], n_(tex.data)[0, 0])
    np.testing.assert_array_equal(out[1], n_(tex.data)[-1, -1])
