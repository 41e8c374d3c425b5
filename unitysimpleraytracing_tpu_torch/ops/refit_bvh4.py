"""The animated frame's geometry update: the refit of a tree's node boxes and
the write of its BVH4 record table, each one hand-written CUDA kernel.

A deforming mesh keeps its tree and moves its triangles, so every frame
refits the node boxes (`pipeline/build.refit_bvh`) and rewrites the record
table's boxes and vertices from a plan made once per topology
(`trace_bvh4._apply_plan4`).  The plain PyTorch versions are
``lbvh.refit`` (a sparse table of windowed min/max) and
`write_records_plain` (a concatenated source array and four gathers); on the
card they took 109 launches a frame.

Kernel note.  `refit_nodes` and `write_records` launch the two kernels of
``csrc/refit_bvh4.cu``; they replace no TPU kernel (the JAX package computes
both as XLA operations).  The refit climbs bottom-up, one thread per sorted
leaf, as the reference does (BVH.compute:172-220): at each internal node the
second of the two arrivals combines both children and goes on.  Min and max
are exact in float32 and both children are combined left first, as the plain
version combines its windows, so the boxes equal ``lbvh.refit``'s bit for
bit in any order of arrival.  The climb needs the parent links, which
`lbvh.topology_links` makes once per topology (four read-backs), and one
arrival counter per node: every call brings two arrivals to each node, so a
counter is even between calls and needs no reset.  The counters belong to a
topology and a stream (`_arrivals`), are zero-filled when they are made, and
the host passes nothing that changes between frames.  The record kernel is
one thread per (record row, entry): it reads the entry's source from the
plan and writes its widened box, its pre-differenced triangle and its meta
into the (cap4, 64) table, with the plain version's float32 operations.
What bounds them is the refit's chain of dependent climbs (one tree level a
step) and the launches, not bytes; ``PERF.md`` has their times on an H100
beside the plain pair's (``benchmarks/kernel_ab.py``, case ``refit``).

On CUDA tensors each wrapper launches its kernel on the current stream
without synchronising, or raises; on CPU tensors it runs the plain version.
``refit_nodes.launches`` and ``write_records.launches`` count the launches.
"""
from __future__ import annotations

import ctypes
import weakref

import torch

from unitysimpleraytracing_tpu_torch.core.types import Bvh, Scene
from unitysimpleraytracing_tpu_torch.ops import lbvh
from unitysimpleraytracing_tpu_torch.utils import kernel_build

KERNEL_NAME = "refit_bvh4"
SLOTS = 64
_BIG = 3.0e38

# id(bvh.left) -> (weakref(left), {(device index, stream handle): counters}).
_ARRIVALS: dict = {}


def _load_kernel(name: str):
    """A C entry point of ``csrc/refit_bvh4.cu`` (``refit_launch`` or
    ``records_launch``), built by nvcc on first use."""
    fn = getattr(kernel_build.load_kernel_library(KERNEL_NAME), name)
    if fn.argtypes is None:
        pointers = 12 if name == "refit_launch" else 10
        fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _arrivals(bvh: Bvh, stream: int) -> torch.Tensor:
    """The refit's arrival counters for this topology on this stream: one
    int32 per node, zero-filled once."""
    key = id(bvh.left)
    ent = _ARRIVALS.get(key)
    if ent is None or ent[0]() is not bvh.left:
        ref = weakref.ref(bvh.left, lambda _r, _k=key: _ARRIVALS.pop(_k, None))
        ent = _ARRIVALS[key] = (ref, {})
    slot = (bvh.left.device.index, stream)
    counters = ent[1].get(slot)
    if counters is None:
        counters = ent[1][slot] = torch.zeros(
            (bvh.capacity,), dtype=torch.int32, device=bvh.left.device)
    return counters


def _checked(name: str, x: torch.Tensor, shape, dtype, device) -> torch.Tensor:
    """``x``, contiguous (a copy only where it is not); raises on another
    dtype, shape or device."""
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, the tree is on {device}")
    return x.contiguous()


def _launch(fn, name: str, device, *args) -> None:
    """Call a C entry point with tensors' pointers on the current stream;
    raises if the launch was refused."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args], stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


@torch.no_grad()
def refit_nodes(bvh: Bvh, tri_aabb_min: torch.Tensor, tri_aabb_max: torch.Tensor):
    """(node_aabb_min, node_aabb_max), each (capacity, 3) float32: the tree's
    internal-node boxes over the given per-triangle boxes, rows from
    ``count - 1`` up 0.0 — ``lbvh.refit`` of the same inputs, bit for bit.

    On CUDA tensors this launches the bottom-up refit kernel, or raises; on
    CPU tensors it runs ``lbvh.refit``."""
    cap, dev = bvh.capacity, bvh.left.device
    if tri_aabb_min.device.type == "cpu":
        return lbvh.refit(bvh.range_first, bvh.range_last, bvh.sorted_tri,
                          tri_aabb_min, tri_aabb_max, bvh.count)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    internal_parent, leaf_parent = lbvh.topology_links(bvh)
    topology = [_checked(n, x, (cap,), dtype, dev) for n, x, dtype in (
        ("left", bvh.left, torch.int32), ("right", bvh.right, torch.int32),
        ("left_is_leaf", bvh.left_is_leaf, torch.bool),
        ("right_is_leaf", bvh.right_is_leaf, torch.bool),
        ("internal_parent", internal_parent, torch.int32),
        ("leaf_parent", leaf_parent, torch.int32),
        ("sorted_tri", bvh.sorted_tri, torch.int32))]
    boxes = [_checked(n, x, (cap, 3), torch.float32, dev) for n, x in (
        ("tri_aabb_min", tri_aabb_min), ("tri_aabb_max", tri_aabb_max))]
    node_min = torch.empty((cap, 3), dtype=torch.float32, device=dev)
    node_max = torch.empty((cap, 3), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _launch(_load_kernel("refit_launch"), "refit", dev, *topology, *boxes,
            _arrivals(bvh, stream), node_min, node_max, bvh.count, cap)
    refit_nodes.launches += 1
    return node_min, node_max


refit_nodes.launches = 0


def write_records_plain(scene: Scene, bvh: Bvh, src_idx, metas) -> torch.Tensor:
    """The plain version of `write_records`: build the unified source array
    and gather each entry's 15 slots (6 box + 9 pre-differenced verts) by the
    plan's source rows."""
    cap = bvh.capacity
    dev = bvh.left.device
    t = scene.triangles
    f32 = dict(dtype=torch.float32, device=dev)
    # Rows [0, cap): internal BVH2 nodes (boxes; verts inert zeros).
    # Rows [cap, 2cap): triangles (leaf box + (a, e1=b−a, e2=c−a) — the
    # pre-differenced Möller–Trumbore form).
    # Row 2cap: the inert EMPTY entry (inverted box, zero verts).
    S = torch.cat(
        [
            torch.cat(
                [bvh.node_aabb_min, bvh.node_aabb_max, torch.zeros((cap, 9), **f32)],
                dim=1,
            ),
            torch.cat(
                [scene.aabb_min, scene.aabb_max, t.a, t.b - t.a, t.c - t.a], dim=1
            ),
            torch.cat(
                [torch.full((1, 3), _BIG, **f32), torch.full((1, 3), -_BIG, **f32),
                 torch.zeros((1, 9), **f32)],
                dim=1,
            ),
        ],
        dim=0,
    )  # (2·cap + 1, 15)

    # Cull-margin widening for scene extents beyond ~8e3: boxes grow by a
    # few ULPs of the extent so rounding in the slab test cannot cull a
    # child whose triangle test would have hit.
    root = torch.maximum(
        bvh.node_aabb_min[0].abs().max(), bvh.node_aabb_max[0].abs().max()
    )
    widen = torch.clamp(root - 8192.0, min=0.0) * 4e-6

    g = [S[src_idx[:, e]] for e in range(4)]  # 4 × (cap4, 15)
    return torch.cat(
        [torch.cat([ge[:, 0:3] - widen, ge[:, 3:6] + widen], dim=1) for ge in g]
        + [metas]
        + [ge[:, 6:15] for ge in g],
        dim=1,
    )  # (cap4, 64): boxes 0-23, metas 24-27, verts 28-63


@torch.no_grad()
def write_records(scene: Scene, bvh: Bvh, src_idx: torch.Tensor,
                  metas: torch.Tensor) -> torch.Tensor:
    """The (cap4, 64) BVH4 record table of a plan (``src_idx`` (cap4, 4)
    int64 source rows and ``metas`` (cap4, 4) float32, `trace_bvh4._pack_plan4`)
    over the scene's triangles and the tree's node boxes.

    On CUDA tensors this launches the record kernel, or raises; on CPU
    tensors it runs `write_records_plain`."""
    if scene.aabb_min.device.type == "cpu":
        return write_records_plain(scene, bvh, src_idx, metas)
    cap, dev = bvh.capacity, bvh.left.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    rows = src_idx.shape[0]
    t = scene.triangles
    named = [("src_idx", src_idx, (rows, 4), torch.int64),
             ("metas", metas, (rows, 4), torch.float32)]
    named += [(n, x, (cap, 3), torch.float32) for n, x in (
        ("node_aabb_min", bvh.node_aabb_min), ("node_aabb_max", bvh.node_aabb_max),
        ("aabb_min", scene.aabb_min), ("aabb_max", scene.aabb_max),
        ("a", t.a), ("b", t.b), ("c", t.c))]
    inputs = [_checked(*entry, dev) for entry in named]
    table = torch.empty((rows, SLOTS), dtype=torch.float32, device=dev)
    _launch(_load_kernel("records_launch"), "records", dev, *inputs, table, rows, cap)
    write_records.launches += 1
    return table


write_records.launches = 0
