"""Scene and BVH checkpoints: one ``.npz`` each.

Counterpart of ``unitysimpleraytracing_tpu/io/checkpoint.py``, with the same
keys and the same format version, so a checkpoint written by either package
loads in the other.  A static scene's build (sort, topology, refit, and for a
chunked scene S trees and their record tables) is pure preprocessing; a
checkpoint restores it and the render path starts at traversal.

Format: one compressed npz; arrays under ``tri/<field>``, ``scene/<field>``
and ``bvh/<field>`` (one tree) or ``sscene/<field>``, ``cbvh/<field>`` and
``cbvh/tables`` (a chunked scene), counts and the kind under ``meta/*``.
Plain numpy only, no pickle.  Morton codes are uint32 in the file and int64
inside the port.

Chunk tables: the port writes the flat forms, (S, cap4, 64) BVH4 records or
(S, cap, 32) binary records.  The JAX package may write binary records
``pack`` = 2 or 4 to a row, (S, cap/2, 64) or (S, cap/4, 128): the same
bytes, which the loader reshapes to (S, cap, 32).  A 64-wide table can be
either BVH4 records or packed binary ones, so the loader re-packs chunk 0's
records from its stored tree in each reading the shape allows, takes the one
that equals the stored bytes, and raises if none does
(`io/convert.chunked_bvh_from_numpy`): a table is never misread.
"""
from __future__ import annotations

import numpy as np
import torch

from unitysimpleraytracing_tpu_torch.core.types import Bvh, Scene
from unitysimpleraytracing_tpu_torch.io import convert
from unitysimpleraytracing_tpu_torch.utils.device import resolve_device

_TRI_FIELDS = (
    "a", "b", "c", "a_uv", "b_uv", "c_uv", "a_normal", "b_normal", "c_normal"
)
_SCENE_FIELDS = ("aabb_min", "aabb_max", "morton", "tri_index")
_BVH_FIELDS = (
    "left", "right", "left_is_leaf", "right_is_leaf",
    "internal_parent", "leaf_parent", "range_first", "range_last",
    "split_axis", "node_aabb_min", "node_aabb_max", "sorted_tri", "depth",
)
_SSCENE_FIELDS = (
    "tri_a", "tri_b", "tri_c", "a_uv", "b_uv", "c_uv",
    "a_normal", "b_normal", "c_normal", "aabb_min", "aabb_max",
    "morton", "global_tri", "counts", "range_min", "range_max",
)
_FORMAT_VERSION = 2  # v2: + range_first/range_last/split_axis


def _np(x: torch.Tensor, morton: bool = False) -> np.ndarray:
    arr = x.detach().cpu().numpy()
    return arr.astype(np.uint32) if morton else arr


def save_checkpoint(path: str, scene: Scene, bvh: Bvh) -> None:
    """Write scene + built BVH to ``path`` (.npz, compressed)."""
    data = {"meta/version": np.int64(_FORMAT_VERSION),
            "meta/scene_count": np.int64(scene.count),
            "meta/bvh_count": np.int64(bvh.count)}
    for f in _TRI_FIELDS:
        data[f"tri/{f}"] = _np(getattr(scene.triangles, f))
    for f in _SCENE_FIELDS:
        data[f"scene/{f}"] = _np(getattr(scene, f), morton=f == "morton")
    for f in _BVH_FIELDS:
        data[f"bvh/{f}"] = _np(getattr(bvh, f))
    np.savez_compressed(path, **data)


def _read(path: str, kind: bytes | None) -> dict:
    """Every array of a checkpoint of this ``kind`` (None = one tree), the
    file closed again."""
    with np.load(path) as npz:
        z = {k: npz[k] for k in npz.files}
    version = int(z["meta/version"])
    if version != _FORMAT_VERSION:
        raise ValueError(f"checkpoint version {version} != {_FORMAT_VERSION}")
    got = bytes(z["meta/kind"]) if "meta/kind" in z else None
    if got != kind:
        want = "load_chunked_checkpoint" if got == b"chunked" else "load_checkpoint"
        raise ValueError(f"{path} is a {'chunked' if got else 'single-tree'} "
                         f"checkpoint (use {want})")
    return z


def load_checkpoint(path: str, device=None) -> tuple[Scene, Bvh]:
    """Restore (scene, bvh) saved by `save_checkpoint` of either package.
    ``device=None`` is the card (raises without one)."""
    device = resolve_device(device)
    z = _read(path, None)
    scene_count = int(z["meta/scene_count"])
    tris = {f: z[f"tri/{f}"] for f in _TRI_FIELDS}
    tris["count"] = scene_count
    scene = convert.scene_from_numpy(
        {"triangles": tris, **{f: z[f"scene/{f}"] for f in _SCENE_FIELDS},
         "count": scene_count}, device)
    bvh = convert.bvh_from_numpy(
        {**{f: z[f"bvh/{f}"] for f in _BVH_FIELDS}, "count": int(z["meta/bvh_count"])},
        device)
    return scene, bvh


def save_chunked_checkpoint(path: str, cbvh) -> None:
    """Persist a `ChunkedBvh` (pipeline/chunked) to one ``.npz``: the
    partition, the S trees and their record tables, so a restore traces with
    no rebuild."""
    data = {"meta/version": np.int64(_FORMAT_VERSION),
            "meta/kind": np.bytes_(b"chunked"),
            "meta/bvh_count": np.int64(cbvh.bvhs.count)}
    for f in _SSCENE_FIELDS:
        data[f"sscene/{f}"] = _np(getattr(cbvh.sscene, f), morton=f == "morton")
    for f in _BVH_FIELDS:
        data[f"cbvh/{f}"] = _np(getattr(cbvh.bvhs, f))
    data["cbvh/tables"] = _np(cbvh.tables)
    np.savez_compressed(path, **data)


def load_chunked_checkpoint(path: str, device=None):
    """Restore a `ChunkedBvh` saved by `save_chunked_checkpoint` of either
    package (see the module doc for the JAX package's packed binary
    tables).  ``device=None`` is the card (raises without one)."""
    device = resolve_device(device)
    z = _read(path, b"chunked")
    return convert.chunked_bvh_from_numpy(
        {"sscene": {f: z[f"sscene/{f}"] for f in _SSCENE_FIELDS},
         "bvhs": {**{f: z[f"cbvh/{f}"] for f in _BVH_FIELDS},
                  "count": int(z["meta/bvh_count"])},
         "tables": z["cbvh/tables"]},
        device)
