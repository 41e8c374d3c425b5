"""Struct-of-arrays scene and BVH containers: plain dataclasses of tensors.

Counterpart of ``unitysimpleraytracing_tpu/core/types.py`` (flax.struct
pytrees there).  Logical element counts stay Python ints.  The dataclasses
compare by identity (``eq=False``): the BVH4 table cache keys on object
identity through weak references.

Morton codes are carried as int64 (torch's uint32 lacks shifts, compares and
cumulative ops); ``io/convert.py`` converts at the boundary.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from unitysimpleraytracing_tpu_torch import constants as C


class _Replace:
    def replace(self, **changes):
        """New container with some fields replaced; untouched fields keep
        their tensor objects (identity matters to the table cache)."""
        return dataclasses.replace(self, **changes)


@dataclass(eq=False)
class Triangles(_Replace):
    """SoA triangle data (reference ``Triangle`` struct, Constants.cginc:36-54).

    Arrays are padded to ``capacity`` rows; only the first ``count`` are real.
    """

    a: torch.Tensor          # (cap, 3) f32 vertex positions
    b: torch.Tensor          # (cap, 3) f32
    c: torch.Tensor          # (cap, 3) f32
    a_uv: torch.Tensor       # (cap, 2) f32
    b_uv: torch.Tensor       # (cap, 2) f32
    c_uv: torch.Tensor       # (cap, 2) f32
    a_normal: torch.Tensor   # (cap, 3) f32
    b_normal: torch.Tensor   # (cap, 3) f32
    c_normal: torch.Tensor   # (cap, 3) f32
    count: int

    @property
    def capacity(self) -> int:
        return self.a.shape[0]


@dataclass(eq=False)
class Scene(_Replace):
    """Everything the build pipeline consumes: triangles + derived
    per-triangle data (reference ``MeshBufferContainer`` buffer set,
    MeshBufferContainer.cs:108-115)."""

    triangles: Triangles
    aabb_min: torch.Tensor   # (cap, 3) f32 — per-triangle AABB, inflated 1e-3
    aabb_max: torch.Tensor   # (cap, 3) f32
    morton: torch.Tensor     # (cap,) int64 — 30-bit codes; padding = 0xFFFFFFFF
    tri_index: torch.Tensor  # (cap,) int32 — 0..n-1; padding = count-1
    count: int

    @property
    def capacity(self) -> int:
        return self.morton.shape[0]


@dataclass(eq=False)
class Bvh(_Replace):
    """Karras LBVH in SoA form.

    ``left[i] == split(i)`` and ``right[i] == split(i)+1`` by construction
    (BVH.compute:111-148), and a leaf's payload index equals its position, so
    no leaf index array is stored.

    Node id space: internal node i ∈ [0, n-1), leaf j ∈ [0, n); node 0 is root.
    """

    left: torch.Tensor            # (cap,) i32 — left child id (leaf or internal)
    right: torch.Tensor           # (cap,) i32
    left_is_leaf: torch.Tensor    # (cap,) bool
    right_is_leaf: torch.Tensor   # (cap,) bool
    internal_parent: torch.Tensor  # (cap,) i32 — parent of internal node; -1 at root
    leaf_parent: torch.Tensor      # (cap,) i32 — parent of each leaf
    range_first: torch.Tensor      # (cap,) i32 — first sorted-leaf index covered
    range_last: torch.Tensor       # (cap,) i32 — last sorted-leaf index covered
    split_axis: torch.Tensor       # (cap,) i32 — Morton axis of the split bit
    node_aabb_min: torch.Tensor    # (cap, 3) f32 — internal-node AABBs
    node_aabb_max: torch.Tensor    # (cap, 3) f32
    sorted_tri: torch.Tensor       # (cap,) i32 — Morton-sorted triangle indices
    depth: torch.Tensor            # (cap,) i32 — internal-node depth from root
    count: int                     # number of leaves (= triangles)

    @property
    def capacity(self) -> int:
        return self.left.shape[0]

    @property
    def num_internal(self) -> int:
        return self.count - 1


@dataclass(eq=False)
class HitRecord(_Replace):
    """Per-ray nearest-hit result (reference ``RaycastResult``,
    Raytracing.compute:31-36). ``t == MAX_FLOAT`` means miss; ``tri`` defaults
    to 0 on miss exactly like the reference (Raytracing.compute:129-131)."""

    t: torch.Tensor    # (R,) f32 hit distance
    tri: torch.Tensor  # (R,) i32 triangle index (unsorted id)
    u: torch.Tensor    # (R,) f32 barycentric u
    v: torch.Tensor    # (R,) f32 barycentric v

    @property
    def hit(self) -> torch.Tensor:
        return self.t != C.MAX_FLOAT
