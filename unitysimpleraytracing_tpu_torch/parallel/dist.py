"""Morton-range triangle partitioning: the single-device part of the
distributed layer.

Counterpart of ``unitysimpleraytracing_tpu/parallel/dist.py`` for what one
device needs: `partition_scene` splits a scene into Morton-contiguous
triangle ranges (the chunks of `pipeline/chunked`), and `_local_build`
builds one Karras LBVH over a range.  The device mesh, the ring, shuffle and
data-parallel engines and their collectives are not part of this module.

Every array of a `ShardedScene` is bit-identical to the JAX package's for the
same scene: Morton codes are int64 here (uint32 at ``io/convert``), padding
rows carry key 0xFFFFFFFF and degenerate geometry (zeros), and an empty shard
gets the inverted root box (+inf, -inf) that no ray can hit.

Tie-breaking across shards is (t, then the shard traced first); within a
shard it is the DFS order of single-tree traversal.  A miss carries triangle
0, as in the reference (Raytracing.compute:178-182).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from unitysimpleraytracing_tpu_torch import constants as C
from unitysimpleraytracing_tpu_torch.core.types import Bvh, Scene, _Replace
from unitysimpleraytracing_tpu_torch.ops import lbvh, sort, unique


@dataclass(eq=False)
class ShardedScene(_Replace):
    """Scene partitioned into Morton-contiguous triangle ranges.

    Every per-triangle array gains a leading shard axis (S, shard_cap, ...).
    ``counts[s]`` is the number of real triangles in shard s; ``global_tri``
    maps shard-local ids back to original mesh triangle ids.
    """

    tri_a: torch.Tensor       # (S, cap, 3) f32
    tri_b: torch.Tensor
    tri_c: torch.Tensor
    a_uv: torch.Tensor        # (S, cap, 2) f32
    b_uv: torch.Tensor
    c_uv: torch.Tensor
    a_normal: torch.Tensor    # (S, cap, 3) f32
    b_normal: torch.Tensor
    c_normal: torch.Tensor
    aabb_min: torch.Tensor    # (S, cap, 3) f32
    aabb_max: torch.Tensor
    morton: torch.Tensor      # (S, cap) int64, sorted within shard; pad 0xFFFFFFFF
    global_tri: torch.Tensor  # (S, cap) int32 original triangle ids
    counts: torch.Tensor      # (S,) int32
    range_min: torch.Tensor   # (S, 3) f32 — per-shard root AABB
    range_max: torch.Tensor   # (S, 3) f32

    @property
    def num_shards(self) -> int:
        return self.morton.shape[0]

    @property
    def shard_capacity(self) -> int:
        return self.morton.shape[1]


# ShardedScene fields in the order of the per-triangle payload below.
_PAYLOAD = (
    ("tri_a", "a"), ("tri_b", "b"), ("tri_c", "c"),
    ("a_uv", "a_uv"), ("b_uv", "b_uv"), ("c_uv", "c_uv"),
    ("a_normal", "a_normal"), ("b_normal", "b_normal"), ("c_normal", "c_normal"),
)


def _payload(scene: Scene):
    """(ShardedScene field name, (capacity, k) scene array) of every
    per-triangle array that a shard carries."""
    t = scene.triangles
    arrays = [(name, getattr(t, src)) for name, src in _PAYLOAD]
    return arrays + [("aabb_min", scene.aabb_min), ("aabb_max", scene.aabb_max)]


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` for an (N, k) tensor as ONE element gather of the flat
    array: on the card a gather of 8- to 16-byte rows by advanced indexing
    takes a one-block-per-row path, an element gather does not (PERF.md)."""
    k = x.shape[1]
    cols = torch.arange(k, dtype=torch.int64, device=x.device)
    flat = idx.to(torch.int64)[:, None] * k + cols
    return x.reshape(-1)[flat.reshape(-1)].reshape(idx.shape[0], k)


def partition_scene(
    scene: Scene,
    num_shards: int,
    pad_multiple: int = C.LANE,
    balance: str = "count",
) -> ShardedScene:
    """Split a scene into ``num_shards`` Morton-contiguous ranges.

    Triangles are sorted by Morton code (stable), then divided into
    contiguous ranges: spatial locality per shard, so most rays meet few
    shards.  ``balance`` chooses the range boundaries:

    - "count": equal triangle counts per shard (balances build work), on the
      scene's device: one sort, then one element gather per array.
    - "area": equal summed triangle surface area per shard; the boundaries
      depend on the data, so this path runs on the host (numpy), as in the
      JAX package.
    """
    if balance == "count":
        return _partition_scene_device(scene, num_shards, pad_multiple)
    if balance != "area":
        raise ValueError(f"unknown balance policy {balance!r}")
    dev = scene.morton.device
    n = scene.count
    keys, order = sort.sort_key_val(scene.morton, scene.tri_index)
    keys = keys.cpu().numpy()
    order = order.cpu().numpy()

    t = scene.triangles
    a = t.a.cpu().numpy()[order[:n]]
    b = t.b.cpu().numpy()[order[:n]]
    c = t.c.cpu().numpy()[order[:n]]
    area = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    cum = np.cumsum(area)  # cum[i] = weight of triangles [0..i]
    targets = cum[-1] * np.arange(num_shards + 1) / num_shards
    # The triangle whose cumulative range contains a target starts the NEXT
    # shard, so one dominant triangle is isolated rather than dragging
    # everything into shard 0.
    bounds = np.searchsorted(cum, targets)
    bounds[0], bounds[-1] = 0, n
    bounds = np.maximum.accumulate(bounds)  # monotone, possibly-empty tails

    per = int(np.max(bounds[1:] - bounds[:-1]))
    cap = C.pad_count(max(per, 2), pad_multiple)

    def shard_gather(arr, fill=0.0):
        arr = arr.cpu().numpy()
        out = np.full((num_shards, cap) + arr.shape[1:], fill, arr.dtype)
        for s in range(num_shards):
            lo, hi = bounds[s], bounds[s + 1]
            out[s, : hi - lo] = arr[order[lo:hi]]
        return torch.from_numpy(out).to(dev)

    counts = (bounds[1:] - bounds[:-1]).astype(np.int32)
    morton = np.full((num_shards, cap), C.KEY_PADDING, np.int64)
    gtri = np.zeros((num_shards, cap), np.int32)
    rmin = np.zeros((num_shards, 3), np.float32)
    rmax = np.zeros((num_shards, 3), np.float32)
    amin_np, amax_np = scene.aabb_min.cpu().numpy(), scene.aabb_max.cpu().numpy()
    for s in range(num_shards):
        lo, hi = bounds[s], bounds[s + 1]
        morton[s, : hi - lo] = keys[lo:hi]
        gtri[s, : hi - lo] = order[lo:hi]
        if hi > lo:
            rmin[s] = amin_np[order[lo:hi]].min(axis=0)
            rmax[s] = amax_np[order[lo:hi]].max(axis=0)
        else:  # empty shard: inverted box no ray can hit
            rmin[s] = np.inf
            rmax[s] = -np.inf

    def dev_(x):
        return torch.from_numpy(x).to(dev)

    return ShardedScene(
        **{name: shard_gather(arr) for name, arr in _payload(scene)},
        morton=dev_(morton), global_tri=dev_(gtri), counts=dev_(counts),
        range_min=dev_(rmin), range_max=dev_(rmax),
    )


@torch.no_grad()
def _partition_scene_device(
    scene: Scene, num_shards: int, pad_multiple: int = C.LANE
) -> ShardedScene:
    """Count-balanced Morton-range partition on the scene's device.

    The boundaries of equal-count shards depend only on ``scene.count``
    (bounds[s] = min(s * ceil(n/S), n)), so row j of shard s is sorted
    triangle s * ceil(n/S) + j while j < counts[s] and padding after it.
    Every array is then ONE element gather from the scene's own arrays by
    that composed index: no host round trip, no row gathers."""
    dev = scene.morton.device
    n = scene.count
    keys, order = sort.sort_key_val(scene.morton, scene.tri_index)

    step = -(-n // num_shards)
    bounds = [min(step * s, n) for s in range(num_shards + 1)]
    counts_host = [bounds[s + 1] - bounds[s] for s in range(num_shards)]
    per = max(counts_host)
    cap = C.pad_count(max(per, 2), pad_multiple)

    counts = torch.tensor(counts_host, dtype=torch.int32, device=dev)
    rows = torch.arange(cap, dtype=torch.int64, device=dev)
    shards = torch.arange(num_shards, dtype=torch.int64, device=dev)
    live = rows[None, :] < counts[:, None].to(torch.int64)          # (S, cap)
    src = torch.where(live, shards[:, None] * step + rows[None, :], 0).reshape(-1)
    live_flat = live.reshape(-1)
    tri = order[src]                                                  # (S*cap,)

    fields = {}
    for name, arr in _payload(scene):
        g = take_rows(arr, tri)
        g = torch.where(live_flat[:, None], g, 0.0)
        fields[name] = g.reshape(num_shards, cap, arr.shape[1])
    morton = torch.where(live_flat, keys[src], C.KEY_PADDING).reshape(num_shards, cap)
    gtri = torch.where(live_flat, tri, 0).to(torch.int32).reshape(num_shards, cap)

    live3 = live[..., None]
    range_min = torch.where(live3, fields["aabb_min"], torch.inf).amin(dim=1)
    range_max = torch.where(live3, fields["aabb_max"], -torch.inf).amax(dim=1)
    return ShardedScene(
        **fields, morton=morton, global_tri=gtri, counts=counts,
        range_min=range_min, range_max=range_max,
    )


@torch.no_grad()
def _local_build(morton_l, aabb_min_l, aabb_max_l, count: int) -> Bvh:
    """Per-shard Karras LBVH over already-sorted local keys (the sort is a
    no-op pass kept for shards fed unsorted data).

    Skewed partitions can leave a shard with 0 or 1 real triangles, for which
    the Karras topology is undefined (the reference requires >= 2 leaves
    too); clamping the count to 2 folds padding rows in as extra leaves —
    harmless, since padding geometry is degenerate (a = b = c = 0: the
    Möller–Trumbore det == 0 reject) and can never win a hit.  ``Bvh.count``
    is the shard capacity, as in the JAX package."""
    cap = morton_l.shape[0]
    iota = torch.arange(cap, dtype=torch.int32, device=morton_l.device)
    keys, sorted_tri = sort.sort_key_val(morton_l, iota)
    count = max(int(count), 2)
    keys = unique.distribute_keys(keys, count)
    bvh = lbvh.build_bvh_from_sorted(keys, sorted_tri, aabb_min_l, aabb_max_l, count)
    return bvh.replace(count=cap)

