"""The benchmark's frozen terrain generator."""
from __future__ import annotations

import numpy as np
import pytest

from rtbench.scenes.terrain import terrain


@pytest.mark.parametrize("res", [2, 24, 182])
def test_triangle_count(res):
    pos, uv, nrm = terrain(res, 80.0, 9.0, 0)
    assert pos.shape == (2 * (res - 1) ** 2, 3, 3) and pos.dtype == np.float32
    assert uv.shape == (pos.shape[0], 3, 2) and nrm.shape == pos.shape


def test_seeds():
    a = terrain(24, 10.0, 2.0, 2**31 + 17)
    b = terrain(24, 10.0, 2.0, 2**31 + 17)
    c = terrain(24, 10.0, 2.0, 2**31 + 18)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert not np.array_equal(terrain(24, 10.0, 2.0, -5)[0], a[0])


def test_equals_the_program_generator_of_today():
    from unitysimpleraytracing_tpu_torch.core.mesh import terrain_mesh

    for seed in (0, 3):
        m = terrain_mesh(24, 10.0, 2.0, seed)
        pos, uv, nrm = terrain(24, 10.0, 2.0, seed)
        assert np.array_equal(pos, m.positions) and np.array_equal(uv, m.uvs)
        assert np.array_equal(nrm, m.normals)


def test_smooth_normals_are_shared_by_every_corner_of_a_vertex():
    pos, _, nrm = terrain(24, 10.0, 2.0, 7, "smooth")
    _, _, face = terrain(24, 10.0, 2.0, 7)
    assert np.allclose(np.linalg.norm(nrm, axis=-1), 1, atol=1e-6)
    key = {}
    for p, n in zip(pos.reshape(-1, 3), nrm.reshape(-1, 3)):
        key.setdefault(p.tobytes(), []).append(n)
    assert len(key) == 24 * 24
    assert all(np.array_equal(ns[0], n) for ns in key.values() for n in ns)
    # Corners of one triangle differ, unlike face normals.
    assert np.abs(nrm[:, 0] - nrm[:, 1]).max() > 1e-2
    assert np.array_equal(face[:, 0], face[:, 1])
    with pytest.raises(ValueError):
        terrain(4, 1.0, 1.0, 0, "flat")


def test_texels_come_from_the_seed():
    from rtbench import plugins

    make = plugins.load("textures", "texels").make
    p = {"texels": 16, "low": 0.2, "high": 1.0}
    a, b, c = make(p, 2**40 + 3), make(p, 2**40 + 3), make(p, 2**40 + 4)
    assert a.shape == (16, 16, 4) and a.dtype == np.float32
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert a[..., :3].min() >= 0.2 and a[..., :3].max() <= 1.0 and (a[..., 3] == 1).all()
