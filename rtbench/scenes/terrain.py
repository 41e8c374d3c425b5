"""The benchmark's own copy of the procedural terrain (numpy only).

Frozen here so that a change to the program's generator cannot move the
yardstick: the scenes, and the reference's answers on them, come from this
file.  A (res x res) heightfield displaced by four smooth sinusoidal octaves,
two triangles a grid cell: 2·(res−1)² triangles.  Normals are the face
normal at every corner (``face``, as the program's generator makes them) or,
per vertex, the normalised sum of the face normals of every triangle that
shares it, weighted by area (``smooth``), so that shading interpolates them.
"""
from __future__ import annotations

import numpy as np

from rtbench.seeds import seed_of


def make(params: dict, seed: int):
    """A configuration's ``scene`` entry, with heights from ``seed``."""
    return terrain(params["res"], params["size"], params["amplitude"], seed,
                   params.get("normals", "face"))


def terrain(res: int, size: float, amplitude: float, seed: int, normals: str = "face"):
    """``(positions, uvs, normals)``: (T, 3, 3), (T, 3, 2) and (T, 3, 3)
    float32 arrays, one row a triangle."""
    if normals not in ("face", "smooth"):
        raise ValueError(f"unknown normals {normals!r}")
    rng = np.random.default_rng(seed_of(seed))
    xs = np.linspace(-size / 2, size / 2, res, dtype=np.float32)
    X, Z = np.meshgrid(xs, xs, indexing="ij")
    Y = np.zeros_like(X)
    for octave in range(4):
        freq = (2.0**octave) * 2.0 * np.pi / size
        phase = rng.uniform(0, 2 * np.pi, size=4)
        amp = amplitude / (2.0**octave)
        Y += amp * np.sin(freq * X + phase[0]) * np.cos(freq * Z + phase[1])
        Y += 0.5 * amp * np.sin(freq * (X + Z) * 0.7 + phase[2])
    V = np.stack([X, Y, Z], axis=-1).astype(np.float32)
    U = np.stack([X, Z], axis=-1).astype(np.float32) / size + 0.5

    def corners(A):
        a00, a01 = A[:-1, :-1].reshape(-1, A.shape[-1]), A[:-1, 1:].reshape(-1, A.shape[-1])
        a10, a11 = A[1:, :-1].reshape(-1, A.shape[-1]), A[1:, 1:].reshape(-1, A.shape[-1])
        return np.concatenate(
            [np.stack([a00, a01, a11], axis=1), np.stack([a00, a11, a10], axis=1)]
        )

    pos, uv = corners(V), corners(U)
    area_n = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
    if normals == "face":
        fn = area_n / np.maximum(np.linalg.norm(area_n, axis=1, keepdims=True), 1e-20)
        nrm = np.repeat(fn[:, None, :], 3, axis=1)
    else:
        ids = corners(np.arange(res * res).reshape(res, res, 1))[..., 0]
        acc = np.zeros((res * res, 3), np.float64)
        for k in range(3):
            np.add.at(acc, ids[:, k], area_n)
        acc /= np.maximum(np.linalg.norm(acc, axis=1, keepdims=True), 1e-20)
        nrm = acc[ids]
    return pos.astype(np.float32), uv.astype(np.float32), nrm.astype(np.float32)
