"""Mesh ingest: OBJ parsing + procedural meshes + device-side scene build.

Replaces the reference's Unity mesh import + host ingest loop
(``Assets/_Scripts/MeshBufferContainer.cs:96-152``).  The host half (OBJ
parsing, procedural meshes, subdivision) is numpy and produces the same
arrays as the JAX package, byte for byte; the flat vertex arrays are shipped
to the device once and the whole derivation (AABB inflation, centroid
normalization, Morton encode) runs there as vectorized tensor code
(`build_scene`).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from unitysimpleraytracing_tpu_torch import constants as C
from unitysimpleraytracing_tpu_torch.core import morton
from unitysimpleraytracing_tpu_torch.core.types import Scene, Triangles
from unitysimpleraytracing_tpu_torch.utils.device import resolve_device
from unitysimpleraytracing_tpu_torch.utils.profiling import span


@dataclass
class MeshData:
    """Host-side triangle mesh: flat per-corner arrays (n_tris*3 rows)."""

    positions: np.ndarray  # (T, 3, 3) f32 — per-triangle corner positions
    uvs: np.ndarray        # (T, 3, 2) f32
    normals: np.ndarray    # (T, 3, 3) f32

    @property
    def num_triangles(self) -> int:
        return self.positions.shape[0]


def load_obj(path: str, flip_x: bool = False, backend: str = "auto") -> MeshData:
    """Wavefront OBJ loader (v/vt/vn/f; fan-triangulates polygons).

    Replaces the Unity importer feeding MeshBufferContainer.cs:117-121.
    ``flip_x=True`` reproduces Unity's right-handed→left-handed OBJ import
    (negated x + reversed winding) for scene-parity runs.

    ``backend``: "native" (the C++ parser, unitysimpleraytracing_tpu_torch/
    native; raises when it cannot be built), "python", or "auto" (native
    when buildable, else python). Both parsers produce identical arrays.
    """
    if backend not in ("auto", "native", "python"):
        raise ValueError(f"unknown load_obj backend {backend!r}")
    if backend != "python":
        from unitysimpleraytracing_tpu_torch import native

        if native.available():
            pos, uv, nrm, has_nrm = native.load_obj_native(path)
            return _finalize_mesh(pos, uv, nrm, has_nrm, flip_x)
        if backend == "native":
            raise RuntimeError(native.build_error() or "native loader unavailable")
    return _load_obj_python(path, flip_x)


def _load_obj_python(path: str, flip_x: bool) -> MeshData:
    vs: list[list[float]] = []
    vts: list[list[float]] = []
    vns: list[list[float]] = []
    faces: list[list[tuple[int, int, int]]] = []
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                vs.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif tag == "vt":
                vts.append([float(parts[1]), float(parts[2])])
            elif tag == "vn":
                vns.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif tag == "f":
                corners = []
                for tok in parts[1:]:
                    comp = tok.split("/")
                    vi = int(comp[0])
                    ti = int(comp[1]) if len(comp) > 1 and comp[1] else 0
                    ni = int(comp[2]) if len(comp) > 2 and comp[2] else 0
                    # OBJ indices are 1-based; negatives are relative.
                    vi = vi - 1 if vi > 0 else len(vs) + vi
                    ti = ti - 1 if ti > 0 else (len(vts) + ti if ti < 0 else -1)
                    ni = ni - 1 if ni > 0 else (len(vns) + ni if ni < 0 else -1)
                    corners.append((vi, ti, ni))
                for k in range(1, len(corners) - 1):  # fan triangulation
                    faces.append([corners[0], corners[k], corners[k + 1]])

    v_arr = np.asarray(vs, dtype=np.float32)
    vt_arr = np.asarray(vts, dtype=np.float32) if vts else np.zeros((1, 2), np.float32)
    vn_arr = np.asarray(vns, dtype=np.float32) if vns else None

    T = len(faces)
    pos = np.zeros((T, 3, 3), np.float32)
    uv = np.zeros((T, 3, 2), np.float32)
    nrm = np.zeros((T, 3, 3), np.float32)
    for t, face in enumerate(faces):
        for k, (vi, ti, ni) in enumerate(face):
            pos[t, k] = v_arr[vi]
            if ti >= 0:
                uv[t, k] = vt_arr[ti]
            if vn_arr is not None and ni >= 0:
                nrm[t, k] = vn_arr[ni]
    return _finalize_mesh(pos, uv, nrm, vn_arr is not None, flip_x)


def _finalize_mesh(pos, uv, nrm, has_nrm: bool, flip_x: bool) -> MeshData:
    """Shared post-parse steps: flat-normal fallback + Unity-style x flip."""
    pos = np.ascontiguousarray(pos, np.float32)
    uv = np.ascontiguousarray(uv, np.float32)
    nrm = np.ascontiguousarray(nrm, np.float32)
    if not has_nrm or not np.any(nrm):
        # Flat normals from geometry when the OBJ carries none.
        e1 = pos[:, 1] - pos[:, 0]
        e2 = pos[:, 2] - pos[:, 0]
        fn = np.cross(e1, e2)
        norm = np.linalg.norm(fn, axis=1, keepdims=True)
        fn = fn / np.maximum(norm, 1e-20)
        nrm = np.repeat(fn[:, None, :], 3, axis=1).astype(np.float32)
    if flip_x:
        pos[:, :, 0] *= -1.0
        nrm[:, :, 0] *= -1.0
        pos = pos[:, ::-1, :].copy()
        uv = uv[:, ::-1, :].copy()
        nrm = nrm[:, ::-1, :].copy()
    return MeshData(positions=pos, uvs=uv, normals=nrm)


def cube_mesh(size: float = 1.0, center=(0.0, 0.0, 0.0)) -> MeshData:
    """12-triangle axis-aligned cube — the BASELINE.json config-1 oracle scene."""
    s = size * 0.5
    cx, cy, cz = center
    corners = np.array(
        [[x, y, z] for x in (-s, s) for y in (-s, s) for z in (-s, s)],
        np.float32,
    ) + np.array([cx, cy, cz], np.float32)
    # Each face: two triangles, outward winding.
    quads = [
        (0, 1, 3, 2),  # -x
        (4, 6, 7, 5),  # +x
        (0, 4, 5, 1),  # -y
        (2, 3, 7, 6),  # +y
        (0, 2, 6, 4),  # -z
        (1, 5, 7, 3),  # +z
    ]
    pos, uv, nrm = [], [], []
    face_uv = np.array([[0, 0], [0, 1], [1, 1], [1, 0]], np.float32)
    for q in quads:
        p = corners[list(q)]
        n = np.cross(p[1] - p[0], p[2] - p[0])
        n = n / np.linalg.norm(n)
        for tri in ((0, 1, 2), (0, 2, 3)):
            pos.append(p[list(tri)])
            uv.append(face_uv[list(tri)])
            nrm.append(np.repeat(n[None], 3, axis=0))
    return MeshData(
        positions=np.stack(pos).astype(np.float32),
        uvs=np.stack(uv).astype(np.float32),
        normals=np.stack(nrm).astype(np.float32),
    )


def random_triangle_soup(
    n: int, seed: int = 0, bound: float = 50.0, tri_size: float = 0.5
) -> MeshData:
    """Procedural benchmark scene: n random small triangles in a cube."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-bound, bound, size=(n, 1, 3)).astype(np.float32)
    offsets = rng.uniform(-tri_size, tri_size, size=(n, 3, 3)).astype(np.float32)
    pos = centers + offsets
    uv = rng.uniform(0, 1, size=(n, 3, 2)).astype(np.float32)
    e1 = pos[:, 1] - pos[:, 0]
    e2 = pos[:, 2] - pos[:, 0]
    fn = np.cross(e1, e2)
    fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-20)
    nrm = np.repeat(fn[:, None, :], 3, axis=1).astype(np.float32)
    return MeshData(positions=pos, uvs=uv, normals=nrm)


def terrain_mesh(
    res: int = 182, size: float = 80.0, amplitude: float = 9.0, seed: int = 0
) -> MeshData:
    """Procedural surface benchmark scene: a (res×res) heightfield displaced by
    smooth sinusoidal octaves — 2·(res−1)² triangles (res=182 → 65 522), a
    Stanford-bunny-class coherent surface (BASELINE.json config 2), unlike
    ``random_triangle_soup`` which is an adversarial worst-case BVH."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(-size / 2, size / 2, res, dtype=np.float32)
    X, Z = np.meshgrid(xs, xs, indexing="ij")
    Y = np.zeros_like(X)
    for octave in range(4):
        freq = (2.0**octave) * 2.0 * np.pi / size
        phase = rng.uniform(0, 2 * np.pi, size=4)
        amp = amplitude / (2.0**octave)
        Y += amp * np.sin(freq * X + phase[0]) * np.cos(freq * Z + phase[1])
        Y += 0.5 * amp * np.sin(freq * (X + Z) * 0.7 + phase[2])
    V = np.stack([X, Y, Z], axis=-1).astype(np.float32)  # (res, res, 3)
    U = np.stack([X, Z], axis=-1).astype(np.float32) / size + 0.5

    v00 = V[:-1, :-1].reshape(-1, 3)
    v01 = V[:-1, 1:].reshape(-1, 3)
    v10 = V[1:, :-1].reshape(-1, 3)
    v11 = V[1:, 1:].reshape(-1, 3)
    u00 = U[:-1, :-1].reshape(-1, 2)
    u01 = U[:-1, 1:].reshape(-1, 2)
    u10 = U[1:, :-1].reshape(-1, 2)
    u11 = U[1:, 1:].reshape(-1, 2)
    pos = np.concatenate(
        [np.stack([v00, v01, v11], axis=1), np.stack([v00, v11, v10], axis=1)]
    )
    uv = np.concatenate(
        [np.stack([u00, u01, u11], axis=1), np.stack([u00, u11, u10], axis=1)]
    )
    e1 = pos[:, 1] - pos[:, 0]
    e2 = pos[:, 2] - pos[:, 0]
    fn = np.cross(e1, e2)
    fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-20)
    nrm = np.repeat(fn[:, None, :], 3, axis=1).astype(np.float32)
    return MeshData(positions=pos.astype(np.float32), uvs=uv.astype(np.float32), normals=nrm)


def subdivide_mesh(
    mesh: MeshData, levels: int = 1, displace: float = 0.0, freq: float = 1.0
) -> MeshData:
    """Midpoint (1→4) subdivision, optionally with a smooth displacement —
    turns the reference's real meshes (3-13K tris, Assets/_Assets/*.obj)
    into multi-100K-triangle scenes for the chunked/large-scene path while
    keeping real-mesh topology (unlike the procedural terrain).

    Each level splits every triangle at its edge midpoints (uv/normals
    interpolated linearly, normals renormalized).  ``displace`` moves every
    corner along a SMOOTH per-position normal (the normalized mean of all
    corner normals sharing that exact position — hard-edged meshes carry a
    different normal per face at a shared corner, so the raw corner normal
    would crack the surface) by a smooth trigonometric field of POSITION.
    Both direction and amplitude are then pure functions of the coordinate,
    so shared corners displace identically and the surface stays
    crack-free.  Shading normals are left as authored.  Deterministic; no
    reference counterpart (the reference hard-caps at 524 288 tris,
    Constants.cs:3-6, and ships 12 800 at most)."""
    pos = mesh.positions.astype(np.float32)
    uv = mesh.uvs.astype(np.float32)
    nrm = mesh.normals.astype(np.float32)
    for _ in range(levels):
        def mids(x):
            a, b, c = x[:, 0], x[:, 1], x[:, 2]
            ab, bc, ca = (a + b) * 0.5, (b + c) * 0.5, (c + a) * 0.5
            return np.concatenate([
                np.stack([a, ab, ca], axis=1),
                np.stack([ab, b, bc], axis=1),
                np.stack([ca, bc, c], axis=1),
                np.stack([ab, bc, ca], axis=1),
            ])

        pos, uv, nrm = mids(pos), mids(uv), mids(nrm)
        nrm = nrm / np.maximum(
            np.linalg.norm(nrm, axis=2, keepdims=True), 1e-20
        )
    if displace:
        # Smooth per-position displacement direction: mean of every corner
        # normal sharing the exact position (midpoints are computed from the
        # same endpoint values in every adjacent triangle, so shared
        # positions are bit-equal and exact-byte grouping is sound).
        flat_p = pos.reshape(-1, 3)
        flat_n = nrm.reshape(-1, 3)
        # Canonicalize signed zeros before the byte-pattern grouping (+0.0 and
        # -0.0 are value-equal but byte-distinct; IEEE maps -0.0+0.0 → +0.0),
        # so value-equal corners always share one displacement direction.
        group_p = np.ascontiguousarray(flat_p + 0.0)
        _, inv_idx = np.unique(
            group_p.view([("x", np.float32), ("y", np.float32), ("z", np.float32)]),
            return_inverse=True,
        )
        inv_idx = inv_idx.ravel()
        acc = np.zeros((inv_idx.max() + 1, 3), np.float64)
        np.add.at(acc, inv_idx, flat_n)
        acc /= np.maximum(np.linalg.norm(acc, axis=1, keepdims=True), 1e-20)
        dir_n = acc[inv_idx].astype(np.float32).reshape(pos.shape)
        # Extent-relative frequency; same field at a given coordinate no
        # matter which triangle evaluates it.
        ext = float(np.max(np.abs(pos))) or 1.0
        k = 2.0 * np.pi * freq / ext
        field = (
            np.sin(k * 3.1 * pos[..., 0] + 0.7)
            * np.cos(k * 2.3 * pos[..., 1] + 1.9)
            + 0.5 * np.sin(k * 5.7 * pos[..., 2] + 4.2)
            * np.cos(k * 4.1 * pos[..., 0] + 2.6)
        )
        pos = pos + dir_n * (displace * field)[..., None]
    return MeshData(
        positions=np.ascontiguousarray(pos, np.float32),
        uvs=np.ascontiguousarray(uv, np.float32),
        normals=np.ascontiguousarray(nrm, np.float32),
    )

def _derive_scene_arrays(pos, count, scene_min, scene_max):
    """Device-side: per-triangle inflated AABB + centroid + Morton code.

    Vectorized equivalent of the reference host loop
    (MeshBufferContainer.cs:123-146 calling :52-83 and :41-50).
    """
    a, b, c = pos[:, 0], pos[:, 1], pos[:, 2]
    amin = torch.minimum(torch.minimum(a, b), c) - C.AABB_INFLATION
    amax = torch.maximum(torch.maximum(a, b), c) + C.AABB_INFLATION
    centroid = (amin + amax) * 0.5
    # NormalizeCentroid (MeshBufferContainer.cs:73-83): affine map to [0,1]^3.
    unit = (centroid - scene_min) / (scene_max - scene_min)
    codes = morton.morton_from_points(unit)
    # Padding rows sort to the tail (MeshBufferContainer.cs:108: keys
    # pre-filled with uint.MaxValue).
    row = torch.arange(pos.shape[0], device=pos.device)
    real = row < count
    codes = torch.where(real, codes, C.KEY_PADDING)
    tri_index = torch.where(real, row, count - 1).to(torch.int32)
    return amin, amax, codes, tri_index


def build_scene(
    mesh: MeshData,
    scene_bound: float | None = None,
    pad_multiple: int = C.VREG,
    device=None,
) -> Scene:
    """Pad a host mesh and derive the sort keys on the device.

    ``scene_bound=None`` computes the tight world bound from the mesh;
    passing ``constants.PARITY_SCENE_BOUND`` (±125) reproduces the reference's
    hard-coded normalization box (MeshBufferContainer.cs:9-15).
    ``device=None`` is the card (raises without one); tests pass "cpu".
    """
    device = resolve_device(device)
    n = mesh.num_triangles
    cap = C.pad_count(n, pad_multiple)

    def pad(arr):
        with span("ingest.pad"):
            out = np.zeros((cap,) + arr.shape[1:], arr.dtype)
            out[:n] = arr
        with span("ingest.upload"):
            return torch.from_numpy(out).to(device)

    pos = pad(mesh.positions)
    uv = pad(mesh.uvs)
    nrm = pad(mesh.normals)

    with span("ingest.pad"):
        if scene_bound is None:
            lo = float(mesh.positions.min()) - 1.0
            hi = float(mesh.positions.max()) + 1.0
        else:
            lo, hi = -scene_bound, scene_bound
    with span("ingest.upload"):
        scene_min = torch.full((3,), lo, dtype=torch.float32, device=device)
        scene_max = torch.full((3,), hi, dtype=torch.float32, device=device)

    with torch.no_grad(), span("ingest.keys"):
        amin, amax, codes, tri_index = _derive_scene_arrays(
            pos, n, scene_min, scene_max
        )
    # Corner slices are made contiguous once here: every later stage (table
    # pack, oracle traversal, shading) gathers rows from them.
    with span("ingest.upload"):
        tris = Triangles(
            a=pos[:, 0].contiguous(), b=pos[:, 1].contiguous(), c=pos[:, 2].contiguous(),
            a_uv=uv[:, 0].contiguous(), b_uv=uv[:, 1].contiguous(),
            c_uv=uv[:, 2].contiguous(),
            a_normal=nrm[:, 0].contiguous(), b_normal=nrm[:, 1].contiguous(),
            c_normal=nrm[:, 2].contiguous(),
            count=n,
        )
    return Scene(
        triangles=tris,
        aabb_min=amin,
        aabb_max=amax,
        morton=codes,
        tri_index=tri_index,
        count=n,
    )
