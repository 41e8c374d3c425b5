"""The reference's shading pieces against what they state: its bilinear
sample equals the program's at today's code, and the bounds it grants
float32's u and v (``uv_tol``, ``rgb_slack``) let a float32 pass through and
refuse a shift of a hundredth."""
from __future__ import annotations

import numpy as np
import torch

from rtbench import reference as R
from rtbench.scenes.terrain import terrain


def test_bilinear_sample_equals_the_programs_of_today():
    from unitysimpleraytracing_tpu_torch.core.texture import Texture, sample_bilinear

    g = torch.Generator().manual_seed(3)
    tex = torch.rand(16, 16, 4, generator=g)
    uv = torch.rand(5000, 2, generator=g) * 1.2 - 0.1
    want = sample_bilinear(Texture(data=tex), uv[:, 0], uv[:, 1])
    got = R.sample_bilinear(tex.to(torch.float64), uv.to(torch.float64))
    assert torch.allclose(got, want.to(torch.float64), atol=1e-6)


def _frame(dtype, shift=0.0):
    pos, uv, nrm = terrain(24, 20.0, 3.0, 5, "smooth")
    tex = np.random.default_rng(1).uniform(0.2, 1.0, (64, 64, 4)).astype(np.float32)
    cam = dict(eye=(14.0, 11.0, 17.0), target=(0.0, 0.0, 0.0), fov_deg=60.0, near=0.3,
               width=48, height=48)
    px = torch.stack(torch.meshgrid(torch.arange(48), torch.arange(48), indexing="xy"),
                     -1).reshape(-1, 2)
    tris = R.Triangles(pos, dtype, "cpu")
    surface = R.Surface(uv, nrm, tex, dtype, "cpu")
    o, d = R.camera_rays(cam, px, dtype, "cpu")
    hit = R.nearest(tris, o, d, judge=dtype == torch.float64)
    ref = R.frame_pixels(tris, surface, cam, px, (0.1, 0.1, 0.12), True,
                         judge=dtype == torch.float64)
    if shift:
        lit = torch.ones_like(hit["tri"] >= 0)
        ref["rgb"] = torch.where((hit["tri"] >= 0)[:, None], surface.color(
            hit["tri"].clamp(min=0), hit["u"] + shift, hit["v"], lit), ref["rgb"])
    return hit, ref


def test_float32_stays_inside_the_bounds_and_a_shift_does_not():
    h64, f64 = _frame(torch.float64)
    h32, f32 = _frame(torch.float32)
    same = (h64["tri"] == h32["tri"]) & (h64["tri"] >= 0) & ~h64["ambiguous"]
    assert same.sum() > 500
    for k in ("u", "v"):
        err = (h32[k].to(torch.float64) - h64[k]).abs()[same]
        assert (err <= h64["uv_tol"][same]).all()
    assert (h64["uv_tol"][same] < 1e-3).all()
    both = same & ~f64["ambiguous"]
    off = (f32["rgb"].to(torch.float64) - f64["rgb"]).abs().amax(1)
    assert (off[both] <= 1e-3 + f64["rgb_slack"][both]).all()
    _, moved = _frame(torch.float64, shift=0.01)
    off = (moved["rgb"] - f64["rgb"]).abs().amax(1)
    assert (off[both] > 1e-3 + f64["rgb_slack"][both]).float().mean() > 0.5
