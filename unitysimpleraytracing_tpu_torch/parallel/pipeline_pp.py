"""Pipeline parallelism: the build and trace stages of a deforming mesh's
frame loop on two ranks.

Counterpart of ``unitysimpleraytracing_tpu/parallel/pipeline_pp.py``.  Every
frame of a dynamic scene needs a full re-sort + rebuild AND a trace; on one
device they serialise.  Here a 2-rank ``pp`` mesh overlaps them:

    step i:   stage 0  builds frame i's LBVH        (deform → sort → build)
              stage 1  traces frame i-1's BVH       (received last step)
              the stage link hands stage 0's tree to stage 1

Steady-state throughput = max(build, trace) instead of build + trace, at a
one-frame latency.  Each rank runs only its own stage (JAX's ``lax.cond`` on
the axis index becomes a Python branch), and stage 1 traces BEFORE the link,
so its trace does not wait for the concurrent build.  The link is one
broadcast of the tree packed as an int32 matrix, so it runs on NCCL and on
gloo over CUDA tensors alike.

Exactness: the pipelined stream equals the serial deform → build_bvh(builder=
"karras") → trace_rays of each frame, bit for bit.
"""
from __future__ import annotations

import torch
import torch.distributed as tdist

from unitysimpleraytracing_tpu_torch.core.types import Bvh, HitRecord, Scene
from unitysimpleraytracing_tpu_torch.ops import dispatch
from unitysimpleraytracing_tpu_torch.parallel.dist import Mesh, mesh_device
from unitysimpleraytracing_tpu_torch.pipeline.build import build_bvh, deform_scene

# The tree fields the trace stage needs, in link order; the rest of a
# non-diagnostic Bvh is -1 filled.
_LINK_FIELDS = ("left", "right", "left_is_leaf", "right_is_leaf", "range_first",
                "range_last", "split_axis", "node_aabb_min", "node_aabb_max", "sorted_tri")
_LINK_WIDTHS = (1, 1, 1, 1, 1, 1, 1, 3, 3, 1, 9)  # and the (cap, 3, 3) positions


def make_pp_mesh(device=None) -> Mesh:
    """A 2-rank (build, trace) pipeline mesh over ranks 0 and 1 of the
    default process group.  Every rank calls it; ranks past the first two are
    outside the mesh (``coords["pp"]`` None)."""
    device = mesh_device(device)
    if not tdist.is_initialized() or tdist.get_world_size() < 2:
        raise ValueError("the pipeline needs a process group of at least 2 ranks")
    group = tdist.group.WORLD if tdist.get_world_size() == 2 else tdist.new_group([0, 1])
    rank = tdist.get_rank()
    return Mesh(shape={"pp": 2}, rank=rank, device=device, groups={"pp": group},
                ranks={"pp": [0, 1]}, coords={"pp": rank if rank < 2 else None})


def _link_payload(bvh: Bvh, pos: torch.Tensor) -> torch.Tensor:
    """(cap, 23) int32: the tree's fields and the frame's positions, bits as
    they are (flags as 0/1)."""
    cols = []
    for name in _LINK_FIELDS:
        x = getattr(bvh, name)
        x = x.to(torch.int32) if x.dtype == torch.bool else x
        cols.append(x.reshape(x.shape[0], -1).view(torch.int32))
    cols.append(pos.reshape(pos.shape[0], 9).view(torch.int32))
    return torch.cat(cols, dim=1)


def _unlink(buf: torch.Tensor, count: int):
    """Inverse of `_link_payload`: (Bvh, positions (cap, 3, 3))."""
    parts, at = [], 0
    for w in _LINK_WIDTHS:
        parts.append(buf[:, at:at + w].contiguous())
        at += w
    f = dict(zip(_LINK_FIELDS, parts))
    ints = {k: f[k][:, 0] for k in ("left", "right", "range_first", "range_last",
                                    "split_axis", "sorted_tri")}
    neg = torch.full_like(ints["left"], -1)
    bvh = Bvh(**ints,
              left_is_leaf=f["left_is_leaf"][:, 0].bool(),
              right_is_leaf=f["right_is_leaf"][:, 0].bool(),
              node_aabb_min=f["node_aabb_min"].view(torch.float32),
              node_aabb_max=f["node_aabb_max"].view(torch.float32),
              internal_parent=neg, leaf_parent=neg, depth=neg, count=count)
    return bvh, parts[-1].view(torch.float32).reshape(-1, 3, 3)


@torch.no_grad()
def render_frames_pipelined(
    scene: Scene,
    positions: torch.Tensor,  # (F, cap, 3, 3) per-frame vertex positions
    origins: torch.Tensor,
    dirs: torch.Tensor,
    mesh: Mesh,
    impl: str = "auto",
) -> HitRecord:
    """Trace F dynamic frames with build (stage 0) and trace (stage 1)
    overlapped.  Returns the per-frame hit records as (F, R) tensors, on both
    ranks of the mesh.

    F + 1 steps: step i builds frame i (i < F) and traces frame i - 1
    (i > 0).  JAX's scan traces a placeholder tree at the fill step and builds
    a dummy frame at the drain step, and drops both rows; eager code skips
    them.  Per-frame results are bit-identical to a serial deform → build →
    trace of the same frame with the same ``impl`` (`ops/dispatch.trace_rays`:
    ``auto`` is the CUDA kernel K1 on the card).  Stage 1's stream reaches
    stage 0 by one broadcast at the end (JAX's pmin / pmax over stage 0's
    neutral rows: the same stream)."""
    stage = mesh.get_local_rank("pp")
    if stage is None:
        raise ValueError(f"rank {mesh.rank} is outside the pipeline mesh")
    for x in (positions, origins, dirs, scene.morton):
        if x.device != mesh.device:
            raise ValueError(f"a tensor on {x.device} given to a mesh on {mesh.device}")
    F, R, cap = positions.shape[0], origins.shape[0], scene.capacity
    group, (src0, src1) = mesh.get_group("pp"), mesh.ranks["pp"]
    dev = mesh.device

    link = None
    out = []
    for i in range(F + 1):
        if stage == 1 and i > 0:
            bvh, pos = _unlink(link, scene.count)
            h = dispatch.trace_rays(deform_scene(scene, pos), bvh, origins, dirs, impl=impl)
            out.append(torch.stack([h.t.view(torch.int32), h.tri, h.u.view(torch.int32),
                                    h.v.view(torch.int32)]))
        if i < F:
            if stage == 0:
                s2 = deform_scene(scene, positions[i])
                link = _link_payload(build_bvh(s2, builder="karras"), positions[i])
            else:
                link = torch.empty((cap, sum(_LINK_WIDTHS)), dtype=torch.int32, device=dev)
            tdist.broadcast(link, src=src0, group=group)

    stream = (torch.stack(out) if stage == 1
              else torch.empty((F, 4, R), dtype=torch.int32, device=dev))
    tdist.broadcast(stream, src=src1, group=group)
    t, tri, u, v = (stream[:, k].contiguous() for k in range(4))
    return HitRecord(t=t.view(torch.float32), tri=tri, u=u.view(torch.float32),
                     v=v.view(torch.float32))
