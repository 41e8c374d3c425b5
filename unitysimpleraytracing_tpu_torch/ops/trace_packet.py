"""Shared-stack packet traversal in plain tensor code.

Counterpart of ``unitysimpleraytracing_tpu/ops/trace_packet.py``.  Rays are
grouped into spatially coherent packets that share ONE traversal stack: each
step pops a single node per packet, box-tests the whole packet against it,
pushes a child if ANY ray hit, and intersects leaf triangles packet-wide.  In
the JAX package this is plain XLA, not a kernel, so here it is plain PyTorch:
an engine for comparison (``impl="packet"``), not a path the card's frames
take — every step is a handful of eager launches and one device→host read.

Exactness: results are bit-identical to the per-ray traversal
(`ops/trace.traverse`), because

- a ray only intersects a leaf when its own slab test passed on the popped
  node (same per-ray gate as the reference), and a ray that misses a node's
  box also misses every descendant box, so the packet's extra visits can
  never add a hit the solo traversal lacks;
- pruning never *reorders* a DFS (blind left-then-right, as
  Raytracing.compute:129-176), so equal-t ties resolve to the same "first
  visited" triangle (strict < at Raytracing.compute:95).

Packets should be spatially coherent (image tiles for primary rays — the
same coherence the reference gets from its 32×32 thread groups).
"""
from __future__ import annotations

import numpy as np
import torch

from unitysimpleraytracing_tpu_torch import constants as C
from unitysimpleraytracing_tpu_torch.core.types import Bvh, HitRecord, Scene
from unitysimpleraytracing_tpu_torch.ops.intersect import ray_box, ray_triangle


def _leaf_intersect(scene: Scene, tri_idx, gate, o, d, inv, state):
    """Packet-wide CheckTriangle against ONE triangle per packet: ``tri_idx``
    is (T,), ``gate`` (T, P), rays (T, P, 3)."""
    t_cur, tri_cur, u_cur, v_cur = state
    idx = tri_idx.to(torch.int64)
    box_ok = ray_box(scene.aabb_min[idx][:, None], scene.aabb_max[idx][:, None], o, inv)
    tris = scene.triangles
    t_new, u_new, v_new = ray_triangle(
        o, d, tris.a[idx][:, None], tris.b[idx][:, None], tris.c[idx][:, None]
    )
    accept = gate & box_ok & (t_new < t_cur)
    return (
        torch.where(accept, t_new, t_cur),
        torch.where(accept, tri_idx[:, None], tri_cur),
        torch.where(accept, u_new, u_cur),
        torch.where(accept, v_new, v_cur),
    )


def _traverse_lockstep(scene: Scene, bvh: Bvh, o, d):
    """Shared-stack DFS of T packets (T, P, 3) advancing together: one loop
    step pops one node for every packet that still has one (what ``vmap`` of
    the JAX ``while_loop`` does); a packet whose stack is empty is left
    untouched."""
    T, P = o.shape[0], o.shape[1]
    dev = o.device
    cap = bvh.capacity
    inv = 1.0 / d
    rows = torch.arange(T, device=dev)

    # Two slack columns: a step pushes at most two entries, so an overflow
    # past the 64 of the per-ray engines is seen by the check below instead
    # of indexing out of range.
    depth = C.TRAVERSAL_STACK_DEPTH
    stack = torch.zeros((T, depth + 2), dtype=torch.int32, device=dev)
    sp = torch.ones((T,), dtype=torch.int64, device=dev)  # stack = [root]
    t = torch.full((T, P), C.MAX_FLOAT, dtype=torch.float32, device=dev)
    tri = torch.zeros((T, P), dtype=torch.int32, device=dev)
    u = torch.zeros((T, P), dtype=torch.float32, device=dev)
    v = torch.zeros((T, P), dtype=torch.float32, device=dev)

    top = 1
    while top > 0:
        active = sp > 0
        spm1 = torch.clamp(sp - 1, min=0)
        node = stack[rows, spm1].clamp(0, cap - 1).to(torch.int64)

        hit = ray_box(
            bvh.node_aabb_min[node][:, None], bvh.node_aabb_max[node][:, None], o, inv
        ) & active[:, None]  # (T, P) per-ray gate
        any_hit = hit.any(dim=1)

        left = bvh.left[node].clamp(0, cap - 1)
        right = bvh.right[node].clamp(0, cap - 1)
        left_leaf = bvh.left_is_leaf[node]
        right_leaf = bvh.right_is_leaf[node]

        # Left child: push internal (if any ray proceeds) or intersect leaf.
        push_l = any_hit & ~left_leaf
        w = push_l.nonzero(as_tuple=True)[0]
        stack[w, spm1[w]] = left[w]
        sp_l = spm1 + push_l
        t, tri, u, v = _leaf_intersect(
            scene, bvh.sorted_tri[left.to(torch.int64)],
            hit & (left_leaf & any_hit)[:, None], o, d, inv, (t, tri, u, v),
        )

        push_r = any_hit & ~right_leaf
        w = push_r.nonzero(as_tuple=True)[0]
        stack[w, sp_l[w]] = right[w]
        sp_r = sp_l + push_r
        t, tri, u, v = _leaf_intersect(
            scene, bvh.sorted_tri[right.to(torch.int64)],
            hit & (right_leaf & any_hit)[:, None], o, d, inv, (t, tri, u, v),
        )

        sp = torch.where(active, sp_r, sp)
        top = int(sp.max())  # the step's one device→host read
        if top > depth:
            raise RuntimeError("traversal stack overflow (tree too deep)")
    return t, tri, u, v


@torch.no_grad()
def traverse_packets(
    scene: Scene,
    bvh: Bvh,
    origins: torch.Tensor,
    dirs: torch.Tensor,
    packet_size: int = 1024,
    serial: bool = False,
) -> HitRecord:
    """Nearest-hit traversal over (R, 3) rays in coherent packets.

    R must be a multiple of ``packet_size``; callers order rays so that
    consecutive rays are spatially coherent (see `tiled_ray_order`).
    Bit-identical to `trace.traverse`.

    ``serial=False`` (default) runs all packets in lockstep: one loop step
    advances every packet's DFS at once, so the per-step cost amortizes
    across the whole frame.  ``serial=True`` runs packets one after another —
    less peak memory, useful for huge frames.
    """
    R = origins.shape[0]
    if R % packet_size:
        raise ValueError(f"{R} rays not divisible by packet {packet_size}")
    T = R // packet_size
    o = origins.reshape(T, packet_size, 3)
    d = dirs.reshape(T, packet_size, 3)
    if serial:
        parts = [_traverse_lockstep(scene, bvh, o[i:i + 1], d[i:i + 1]) for i in range(T)]
        t, tri, u, v = (torch.cat(p) for p in zip(*parts))
    else:
        t, tri, u, v = _traverse_lockstep(scene, bvh, o, d)
    return HitRecord(t=t.reshape(R), tri=tri.reshape(R), u=u.reshape(R), v=v.reshape(R))


def tiled_ray_order(height: int, width: int, tile: int = 32):
    """Permutation mapping row-major pixel order → 2D-tile-major order
    (the reference's 32×32 thread-group locality), plus its inverse.

    Width/height must be multiples of ``tile`` (pad the image if not).
    Returns (perm, inv_perm) as numpy arrays: ``rays[perm]`` is tile-major;
    ``hits[inv_perm]`` restores row-major.
    """
    if height % tile or width % tile:
        raise ValueError(f"{height}x{width} is not a multiple of the {tile}-pixel tile")
    idx = np.arange(height * width).reshape(height, width)
    tiles = idx.reshape(height // tile, tile, width // tile, tile)
    perm = tiles.transpose(0, 2, 1, 3).reshape(-1)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return perm, inv
