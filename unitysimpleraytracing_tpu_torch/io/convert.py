"""Carry state between numpy (or anything ``np.asarray`` accepts, such as the
JAX package's containers) and the port's containers.

Inputs are plain dicts, or any object with the same field names, of arrays.
With these a test hands a JAX-built ``Scene``/``Bvh`` to the port's table
packer, traversal and renderer, and port-built ones back for bit comparison.
Morton codes are uint32 on the numpy side and int64 inside the port.  Record
tables, stacked cameras, the (T, 3, 3) corner positions of the animated path
and the chunked path's partition and trees cross the same way.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from unitysimpleraytracing_tpu_torch.core.camera import Camera
from unitysimpleraytracing_tpu_torch.core.texture import Texture
from unitysimpleraytracing_tpu_torch.core.types import Bvh, Scene, Triangles
from unitysimpleraytracing_tpu_torch.utils.device import resolve_device


def _get(d, name):
    return d[name] if isinstance(d, dict) else getattr(d, name)


def _tensor(x, device, dtype=None) -> torch.Tensor:
    arr = np.ascontiguousarray(np.asarray(x))
    if arr.dtype == np.uint32:
        arr = arr.astype(np.int64)
    t = torch.from_numpy(arr.copy()).to(device)
    return t if dtype is None else t.to(dtype)


def _from_fields(cls, d, device, static=("count", "width", "height")):
    kw = {}
    for f in dataclasses.fields(cls):
        v = _get(d, f.name)
        kw[f.name] = int(v) if f.name in static else _tensor(v, device)
    return cls(**kw)


def triangles_from_numpy(d, device=None) -> Triangles:
    return _from_fields(Triangles, d, resolve_device(device))


def scene_from_numpy(d, device=None) -> Scene:
    """Scene from a dict/object with the Scene field names; ``morton`` may be
    uint32 (converted to the port's int64 convention)."""
    device = resolve_device(device)
    return Scene(
        triangles=triangles_from_numpy(_get(d, "triangles"), device),
        aabb_min=_tensor(_get(d, "aabb_min"), device),
        aabb_max=_tensor(_get(d, "aabb_max"), device),
        morton=_tensor(_get(d, "morton"), device, torch.int64),
        tri_index=_tensor(_get(d, "tri_index"), device, torch.int32),
        count=int(_get(d, "count")),
    )


def bvh_from_numpy(d, device=None) -> Bvh:
    return _from_fields(Bvh, d, resolve_device(device))


def camera_from_numpy(d, device=None) -> Camera:
    """One camera, or a stack of F cameras (tensor fields with a leading F
    axis, as `core.camera.stack_cameras` and the JAX package's stacked
    pytree have them)."""
    return _from_fields(Camera, d, resolve_device(device))


def table_from_numpy(table, device=None) -> torch.Tensor:
    """A record table packed elsewhere — ``(cap, 32)`` binary records (the
    JAX package's ``pack_tables(pack=1)``; its pack=2|4 views go in
    reshaped to 32 columns) or ``(cap4, 64)`` BVH4 records — as the float32
    tensor the port's traversals take."""
    arr = np.asarray(table)
    if arr.dtype != np.float32 or arr.ndim != 2 or arr.shape[1] not in (32, 64):
        raise ValueError(
            f"not a float32 (cap, 32) or (cap4, 64) record table: {arr.dtype} {arr.shape}")
    return _tensor(arr, resolve_device(device))


def sharded_scene_from_numpy(d, device=None):
    """A `parallel/dist.ShardedScene` from a dict/object with its 16 field
    names (``morton`` may be uint32)."""
    from unitysimpleraytracing_tpu_torch.parallel.dist import ShardedScene

    device = resolve_device(device)
    kw = {f.name: _tensor(_get(d, f.name), device) for f in dataclasses.fields(ShardedScene)}
    return ShardedScene(**kw)


def chunked_bvh_from_numpy(d, device=None):
    """A `pipeline/chunked.ChunkedBvh` from a dict/object with fields
    ``sscene`` (ShardedScene fields), ``bvhs`` (Bvh fields stacked on axis 0,
    ``count`` = the chunk capacity) and ``tables``.

    The table's layout is read from its shape and checked against chunk 0:
    (S, cap4, 64) BVH4 records, or binary records, flat (S, cap, 32) or ``pack`` = 2 or 4 to a row as the
    JAX package may store them, (S, cap/2, 64) or (S, cap/4, 128): the same
    bytes, reshaped here to (S, cap, 32).  Chunk 0's records are re-packed
    from its stored tree in each reading the shape allows, and the first
    reading whose bytes equal the stored ones is taken; a table that matches
    none raises ``ValueError``, so no table is ever misread."""
    from unitysimpleraytracing_tpu_torch.ops import trace_bvh2, trace_bvh4
    from unitysimpleraytracing_tpu_torch.pipeline import chunked

    device = resolve_device(device)
    sscene = sharded_scene_from_numpy(_get(d, "sscene"), device)
    bvhs = bvh_from_numpy(_get(d, "bvhs"), device)
    arr = np.asarray(_get(d, "tables"))
    S, cap = sscene.num_shards, sscene.shard_capacity
    if arr.dtype != np.float32 or arr.ndim != 3 or arr.shape[0] != S:
        raise ValueError(f"not a float32 (S={S}, rows, slots) chunk table: "
                         f"{arr.dtype} {arr.shape}")
    rows, width = arr.shape[1:]
    scene0 = chunked._chunk_scene(sscene, 0, cap)
    bvh0 = chunked._chunk_bvh(bvhs, 0, cap)

    readings = []
    if width == 64 and trace_bvh4._node_mask_cached(bvh0)[2] <= rows:
        readings.append((arr, lambda: trace_bvh4.pack_tables4(scene0, bvh0, cap4=rows)))
    if width in (32, 64, 128) and rows * width == cap * 32 and cap <= trace_bvh2.MAX_CAPACITY:
        readings.append((arr.reshape(S, cap, 32),
                         lambda: trace_bvh2.pack_tables(scene0, bvh0)))
    for table, repack in readings:
        want = repack().cpu().numpy()
        if want.shape == table.shape[1:] and np.array_equal(
                want.view(np.uint32), table[0].view(np.uint32)):
            tables = _tensor(np.ascontiguousarray(table), device)
            return chunked.ChunkedBvh(sscene=sscene, bvhs=bvhs, tables=tables)
    raise ValueError(
        f"chunk table {arr.shape} matches neither the BVH4 nor the binary records "
        f"re-packed from chunk 0's stored tree")


def positions_from_numpy(positions, device=None) -> torch.Tensor:
    """The (T, 3, 3) float32 corner positions `deform_scene` and the
    animated renderer's ``frame`` take (T = the scene's padded capacity)."""
    arr = np.asarray(positions)
    if arr.dtype != np.float32 or arr.ndim != 3 or arr.shape[1:] != (3, 3):
        raise ValueError(f"not float32 (T, 3, 3) corner positions: {arr.dtype} {arr.shape}")
    return _tensor(arr, resolve_device(device))


def texture_from_numpy(d, device=None) -> Texture:
    return _from_fields(Texture, d, resolve_device(device))


def to_numpy(obj):
    """Inverse: a container of the port → a dict of numpy arrays (nested for
    ``Scene.triangles``); ``Scene.morton`` comes back as uint32."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = to_numpy(v)
        elif isinstance(v, torch.Tensor):
            arr = v.detach().cpu().numpy()
            if f.name == "morton":
                arr = arr.astype(np.uint32)
            out[f.name] = arr
        else:
            out[f.name] = v
    return out
