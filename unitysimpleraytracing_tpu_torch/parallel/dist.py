"""Multi-device rendering: Morton-range triangle partitioning and ray data
parallelism over a (dp, tp) mesh of ``torch.distributed`` ranks.

Counterpart of ``unitysimpleraytracing_tpu/parallel/dist.py``.  Parallel axes:

- ``dp`` (data parallel): the ray batch is split; each rank traces its block.
  Exact: every ray sees a full BVH of the triangles it is tested against.
- ``tp`` (Morton-range parallel): triangles are partitioned into
  Morton-contiguous ranges after the global sort (`partition_scene`); each
  rank builds a Karras LBVH over its range (`_local_build`) and traces rays
  against it; per-ray results combine across ``tp`` by an all-gather and a
  first-minimum select (`render_hits_sharded`), by a ring of hops
  (`render_hits_ring`) or by a ragged all-to-all shuffle of rays to the
  ranges they enter (`render_hits_shuffle`).

The mesh is `torch.distributed`'s ``DeviceMesh`` (`make_mesh`, wrapped in
`Mesh`): NCCL on the card, gloo on the CPU, and gloo over CUDA tensors where
several ranks share one card (NCCL refuses two ranks on one GPU).  Every engine takes the whole
`ShardedScene` and the whole ray batch on every rank, as ``shard_map``'s inputs
are global in the JAX package, and returns THIS rank's rows of the result
(`ray_block` says which).  Collectives move int32 matrices, float32 columns
carried as their bits, so ids and floats cross ranks exactly.  Nothing of the
rays or the payloads goes to the host: the only host reads are the shard's
triangle count (for `_local_build`) and the shuffle's S x S sizes matrix,
counted in ``Mesh.host_reads``.

Every array of a `ShardedScene` is bit-identical to the JAX package's for the
same scene: Morton codes are int64 here (uint32 at ``io/convert``), padding
rows carry key 0xFFFFFFFF and degenerate geometry (zeros), and an empty shard
gets the inverted root box (+inf, -inf) that no ray can hit.

Tie-breaking across shards is (t, then lowest shard = lowest Morton range) in
the all-gather and shuffle combines, and (t, then the shard visited first) in
the ring; within a shard it is the DFS order of single-tree traversal.  A miss
carries shard-local triangle 0's attributes, as in the reference
(Raytracing.compute:178-182): compare u, v, uv and normal on hits only.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as tdist
from torch.distributed.device_mesh import init_device_mesh

from unitysimpleraytracing_tpu_torch import constants as C
from unitysimpleraytracing_tpu_torch.core.types import Bvh, HitRecord, Scene, Triangles, _Replace
from unitysimpleraytracing_tpu_torch.ops import dispatch, lbvh, sort, unique
from unitysimpleraytracing_tpu_torch.utils.device import resolve_device


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


# --------------------------------------------------------------------------
# The mesh
# --------------------------------------------------------------------------


@dataclass(eq=False)
class Mesh:
    """A mesh of ``torch.distributed`` ranks: the port's `jax.sharding.Mesh`.

    ``shape`` maps axis names to sizes, as JAX's ``mesh.shape`` does.
    ``groups[axis]`` is the process group of this rank's line along the axis
    (from `make_mesh`'s ``DeviceMesh``),
    ``ranks[axis]`` the global ranks of that line in axis order, and
    ``coords[axis]`` this rank's index in it (None on a rank outside the
    mesh, as the ranks past the first two of `pipeline_pp.make_pp_mesh`).
    ``host_reads`` counts the engines' device-to-host reads and
    ``copies_sent`` the rows the shuffle sent (one per ray and shard it
    enters); a caller may zero them."""

    shape: dict
    rank: int
    device: torch.device
    groups: dict
    ranks: dict
    coords: dict
    host_reads: int = 0
    copies_sent: int = 0

    def get_group(self, axis: str):
        return self.groups[axis]

    def get_local_rank(self, axis: str):
        return self.coords[axis]


def mesh_device(device=None) -> torch.device:
    """The device a rank's tensors live on: ``device`` as given, or the card
    (``cuda:<LOCAL_RANK mod cards>`` for the bare ``"cuda"``, so torchrun's
    ranks of one host take one card each)."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        device = torch.device("cuda", local % torch.cuda.device_count())
    return device


def make_mesh(dp: int, tp: int, device=None) -> Mesh:
    """(dp, tp) mesh over the ranks of the default process group
    (``init_device_mesh``): rank r sits at (r // tp, r % tp), as JAX's
    ``devices[:dp*tp].reshape(dp, tp)``.

    Every rank must call it (it creates the row and column groups).  With no
    process group initialised and ``dp * tp == 1`` it starts a one-process
    group itself (NCCL on the card, gloo on the CPU), so the engines run on one
    device without a launcher, as JAX's mesh does; otherwise the world size
    must equal ``dp * tp``."""
    device = mesh_device(device)
    if not tdist.is_initialized():
        if dp * tp != 1:
            raise RuntimeError(
                f"a ({dp}, {tp}) mesh needs an initialised process group of "
                f"{dp * tp} ranks (multihost.initialize or torchrun)")
        backend = "nccl" if device.type == "cuda" else "gloo"
        tdist.init_process_group(backend, store=tdist.HashStore(), rank=0, world_size=1)
    world = tdist.get_world_size()
    if world != dp * tp:
        raise ValueError(f"the process group has {world} ranks, the mesh needs {dp * tp}")
    if device.type == "cuda":
        torch.cuda.set_device(device)  # the card DeviceMesh binds this rank to
    dm = init_device_mesh(device.type, (dp, tp), mesh_dim_names=("dp", "tp"))
    i, j = dm.get_local_rank("dp"), dm.get_local_rank("tp")
    return Mesh(shape={"dp": dp, "tp": tp}, rank=tdist.get_rank(), device=device,
                groups={"dp": dm.get_group("dp"), "tp": dm.get_group("tp")},
                ranks={"dp": [k * tp + j for k in range(dp)],
                       "tp": [i * tp + k for k in range(tp)]},
                coords={"dp": i, "tp": j})


def ray_block(mesh: Mesh, n: int, layout) -> slice:
    """This rank's rows of an ``n``-row batch under a layout: ``"dp"`` (JAX's
    ``P("dp")``: split over dp, replicated over tp), ``("dp", "tp")``
    (``P(("dp", "tp"))``: split over every rank, dp major) or None
    (replicated)."""
    if layout is None:
        return slice(0, n)
    axes = (layout,) if isinstance(layout, str) else tuple(layout)
    blocks, index = 1, 0
    for axis in axes:
        blocks *= mesh.shape[axis]
        index = index * mesh.shape[axis] + mesh.get_local_rank(axis)
    if n % blocks:
        raise ValueError(f"{n} rays do not divide into {blocks} blocks ({layout})")
    per = n // blocks
    return slice(index * per, (index + 1) * per)


def _on_mesh(mesh: Mesh, *tensors) -> None:
    for x in tensors:
        if x.device != mesh.device:
            raise ValueError(f"a tensor on {x.device} given to a mesh on {mesh.device}")


def _host_read(mesh: Mesh, x: torch.Tensor) -> list:
    """The engines' one way to the host: a small integer tensor as a list."""
    mesh.host_reads += 1
    return x.tolist()


# Exchanged rows are int32 matrices; float32 columns travel as their bits.
_PAYLOAD_COLUMNS = ((1, torch.float32), (1, torch.int32), (1, torch.float32),
                    (1, torch.float32), (2, torch.float32), (3, torch.float32))
_RAY_COLUMNS = ((3, torch.float32), (3, torch.float32))


def _pack(*xs: torch.Tensor) -> torch.Tensor:
    """Columns of one (R, C) int32 matrix, each x's bits as they are."""
    n = xs[0].shape[0]
    return torch.cat([x.reshape(n, -1).view(torch.int32) for x in xs], dim=1)


def _unpack(m: torch.Tensor, columns) -> list[torch.Tensor]:
    """Inverse of `_pack` for ``columns`` = ((width, dtype), ...)."""
    out, at = [], 0
    for width, dtype in columns:
        x = m[:, at:at + width].contiguous().view(dtype)
        out.append(x[:, 0] if width == 1 else x)
        at += width
    return out


def _all_gather(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """(size, *x.shape): x of every rank along ``axis``, in axis order."""
    size, x = mesh.shape[axis], x.contiguous()
    out = torch.empty((size * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    tdist.all_gather_into_tensor(out, x, group=mesh.get_group(axis))
    return out.reshape((size,) + tuple(x.shape))


def _ring_shift(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """JAX's ``ppermute(x, "tp", [(i, i + 1 mod tp)])``: x goes to the next
    rank of the tp ring and the previous rank's x comes in, as one
    all-to-all whose only nonzero splits are those two (gloo has no send or
    receive of CUDA tensors; an all-to-all runs on NCCL and gloo alike)."""
    size, me, n = mesh.shape["tp"], mesh.get_local_rank("tp"), x.shape[0]
    nxt, prv = (me + 1) % size, (me - 1) % size
    out = torch.empty_like(x)
    tdist.all_to_all_single(
        out, x.contiguous(),
        output_split_sizes=[n if j == prv else 0 for j in range(size)],
        input_split_sizes=[n if j == nxt else 0 for j in range(size)],
        group=mesh.get_group("tp"))
    return out


def _ragged_a2a(op, out, send_sizes: list[int], recv_sizes: list[int], group):
    """JAX's ``ragged_all_to_all`` in the layout the shuffle gives it: rank i
    sends rows ``op[sum(send_sizes[:j]) : sum(send_sizes[:j + 1])]`` to peer
    j, and peer j's rows land in ``out`` contiguously in source order from
    row 0 (JAX's ``out_off`` / ``rev_out_off`` are exactly these exclusive
    cumulative sums of the sizes matrix).  Rows of ``out`` past
    ``sum(recv_sizes)`` are left as they are.  Zero sizes are allowed.
    Returns ``out``."""
    total, sent = sum(recv_sizes), sum(send_sizes)
    tdist.all_to_all_single(out[:total], op[:sent].contiguous(),
                            output_split_sizes=list(recv_sizes),
                            input_split_sizes=list(send_sizes), group=group)
    return out


# --------------------------------------------------------------------------
# One shard: its scene, its tree, its trace and shading payload
# --------------------------------------------------------------------------


def _shard_fields(sscene: ShardedScene, s: int) -> tuple:
    """Shard s's arrays in the order `_shard_scene_view` takes them."""
    return tuple(getattr(sscene, name)[s] for name, _ in _PAYLOAD) + (
        sscene.aabb_min[s], sscene.aabb_max[s], sscene.morton[s], sscene.global_tri[s])


def _shard_scene_view(ss_fields, cap: int) -> Scene:
    """Wrap one shard's local arrays in the Scene container the traversal
    takes."""
    (ta, tb, tc, auv, buv, cuv, an, bn, cn, amin, amax, morton, gtri) = ss_fields
    tris = Triangles(a=ta, b=tb, c=tc, a_uv=auv, b_uv=buv, c_uv=cuv,
                     a_normal=an, b_normal=bn, c_normal=cn, count=cap)
    return Scene(triangles=tris, aabb_min=amin, aabb_max=amax, morton=morton,
                 tri_index=gtri, count=cap)


def _payload_of(scene_l: Scene, global_tri: torch.Tensor, h: HitRecord) -> torch.Tensor:
    """(R, 9) packed (t, global tri, u, v, uv, normal) of a shard's hits: the
    barycentric sums in the port's fixed order, ((w a + u b) + v c)."""
    tri = h.tri.to(torch.int64)
    w = (1.0 - h.u - h.v)[:, None]
    bu, bv = h.u[:, None], h.v[:, None]
    t = scene_l.triangles

    def interp(a, b, c):
        return w * take_rows(a, tri) + bu * take_rows(b, tri) + bv * take_rows(c, tri)

    uv = interp(t.a_uv, t.b_uv, t.c_uv)
    normal = interp(t.a_normal, t.b_normal, t.c_normal)
    return _pack(h.t, global_tri[tri], h.u, h.v, uv, normal)


def _trace_packed(scene_l, bvh, global_tri, o, d, impl, t_init=None) -> torch.Tensor:
    """Trace rays against one shard and return the packed payload; zero rays
    launch nothing."""
    if o.shape[0] == 0:
        return torch.empty((0, 9), dtype=torch.int32, device=o.device)
    h = dispatch.trace_rays(scene_l, bvh, o.contiguous(), d.contiguous(), impl=impl,
                            t_init=t_init)
    return _payload_of(scene_l, global_tri, h)


def _shard_tree(ss_fields, count: int):
    """(scene view, tree, global ids) of one shard's arrays and count."""
    scene_l = _shard_scene_view(ss_fields, ss_fields[11].shape[0])
    bvh = _local_build(ss_fields[11], ss_fields[9], ss_fields[10], count)
    return scene_l, bvh, ss_fields[12]


def _shard(sscene: ShardedScene, s: int, mesh: Mesh):
    """(scene view, tree, global ids) of shard s; reads its count (one host
    read)."""
    return _shard_tree(_shard_fields(sscene, s), _host_read(mesh, sscene.counts[s]))


def _trace_and_payload(ss_fields, count, origins, dirs, impl="auto"):
    """Local build + trace + shading payload for one shard: (t, global tri,
    u, v, uv, normal)."""
    packed = _trace_packed(*_shard_tree(ss_fields, count), origins, dirs, impl)
    return tuple(_unpack(packed, _PAYLOAD_COLUMNS))


def _entry_t(o: torch.Tensor, d: torch.Tensor, box_min: torch.Tensor,
             box_max: torch.Tensor) -> torch.Tensor:
    """(R, S) slab entry distance of each ray to each box (S, 3), +inf where
    the ray misses the box or the box is empty.

    The slab test and its arithmetic are JAX's (``dist.py:427-435``).  An
    empty shard's inverted box (+inf, -inf) passes that test with entry 0 in
    both packages; here it is refused, so no ray is traced against or sent to
    a shard that has no triangle to hit (results are the same either way)."""
    inv = 1.0 / d
    t1 = (box_min[None, :, :] - o[:, None, :]) * inv[:, None, :]
    t2 = (box_max[None, :, :] - o[:, None, :]) * inv[:, None, :]
    tmin = torch.minimum(t1, t2).amax(dim=2)
    tmax = torch.maximum(t1, t2).amin(dim=2)
    nonempty = (box_min <= box_max).all(dim=1)
    enters = (tmax > tmin) & (tmax > 0) & nonempty[None, :]
    return torch.where(enters, torch.clamp_min(tmin, 0.0), torch.inf)


def _miss_ray(box_max: torch.Tensor):
    """A ray that never sees a shard's box: its origin far past the box's
    max corner, pointing further away.  ``nan_to_num`` keeps the empty
    shard's -inf corner finite."""
    base = torch.nan_to_num(box_max, posinf=0.0, neginf=0.0)
    origin = base + torch.clamp_min(base.abs().max(), 1.0) + 1e6
    # +x, made on the device: a Python value written into a CUDA tensor
    # would be a copy from the host, which synchronises
    direction = torch.eye(3, dtype=torch.float32, device=box_max.device)[0]
    return origin, direction


def _check_engine(sscene: ShardedScene, origins, dirs, mesh: Mesh, blocks: int) -> None:
    if sscene.num_shards != mesh.shape["tp"]:
        raise ValueError(
            f"scene has {sscene.num_shards} shards but mesh tp={mesh.shape['tp']}")
    if origins.shape[0] % blocks:
        raise ValueError(f"{origins.shape[0]} rays do not divide into {blocks} blocks")
    _on_mesh(mesh, origins, dirs, sscene.morton, sscene.tri_a)


# --------------------------------------------------------------------------
# The engines
# --------------------------------------------------------------------------


@torch.no_grad()
def render_hits_sharded(sscene: ShardedScene, origins: torch.Tensor, dirs: torch.Tensor,
                        mesh: Mesh, impl: str = "auto"):
    """Build + trace over a (dp, tp) mesh: shard ``tp``'s range against the
    rays of block ``dp``, the per-ray payloads all-gathered over tp, the
    first minimum of t wins (ties: lowest shard).

    Returns this rank's rows (``ray_block(mesh, R, "dp")``) of (t, global
    tri, u, v, uv (R, 2), normal (R, 3)), the shading payload interpolated on
    the shard that owns the triangle.  ``impl`` selects the per-shard
    traversal engine (``auto``: the CUDA kernel K1 on the card, its plain
    version on the CPU; `ops/dispatch.resolve_impl`)."""
    _check_engine(sscene, origins, dirs, mesh, mesh.shape["dp"])
    rows = ray_block(mesh, origins.shape[0], "dp")
    scene_l, bvh, gtri = _shard(sscene, mesh.get_local_rank("tp"), mesh)
    packed = _trace_packed(scene_l, bvh, gtri, origins[rows], dirs[rows], impl)
    gathered = _all_gather(packed, mesh, "tp")                     # (tp, R, 9)
    win = torch.argmin(gathered[:, :, 0].view(torch.float32), dim=0)  # first min
    index = win[None, :, None].expand(1, win.shape[0], gathered.shape[2])
    return tuple(_unpack(gathered.gather(0, index)[0], _PAYLOAD_COLUMNS))


@torch.no_grad()
def render_hits_ring(sscene: ShardedScene, origins: torch.Tensor, dirs: torch.Tensor,
                     mesh: Mesh, impl: str = "auto"):
    """Ring exchange over ``tp``: rays are split over every rank, and each
    block circulates the tp ring.  Each of the tp hops traces the resident
    block against the local shard with ``t_init`` = its running best t and
    folds the result in; then rays and state move one rank on, so after tp
    hops every block is home.  Exchanged state per ray is constant (6 ray
    and 9 hit words), whatever tp is.

    Early-out: a ray skips a hop when its best t is closer than its entry
    distance to the shard's root box (any hit inside the box is at least that
    far, so the skip is exact); a skipped ray is traced as a guaranteed miss,
    which leaves the walk at its root.  Ties between shards go to the shard
    visited first.

    Returns this rank's rows (``ray_block(mesh, R, ("dp", "tp"))``) of the
    payload tuple of `render_hits_sharded`."""
    size = mesh.shape["tp"]
    _check_engine(sscene, origins, dirs, mesh, mesh.shape["dp"] * size)
    me = mesh.get_local_rank("tp")
    rows = ray_block(mesh, origins.shape[0], ("dp", "tp"))
    scene_l, bvh, gtri = _shard(sscene, me, mesh)
    box_min, box_max = sscene.range_min[me:me + 1], sscene.range_max[me:me + 1]
    miss_o, miss_d = _miss_ray(sscene.range_max[me])

    o, d = origins[rows], dirs[rows]
    n = o.shape[0]
    dev = o.device
    best = _pack(torch.full((n,), C.MAX_FLOAT, dtype=torch.float32, device=dev),
                 torch.zeros((n, 8), dtype=torch.float32, device=dev))
    for _hop in range(size):
        t_b = best[:, 0].contiguous().view(torch.float32)
        gate = _entry_t(o, d, box_min, box_max)[:, 0] < t_b
        o_eff = torch.where(gate[:, None], o, miss_o)
        d_eff = torch.where(gate[:, None], d, miss_d)
        new = _trace_packed(scene_l, bvh, gtri, o_eff, d_eff, impl, t_init=t_b)
        win = gate & (new[:, 0].view(torch.float32) < t_b)
        best = torch.where(win[:, None], new, best)
        if size > 1:
            o, d, best = _unpack(_ring_shift(_pack(o, d, best), mesh),
                                 _RAY_COLUMNS + ((9, torch.int32),))
    return tuple(_unpack(best, _PAYLOAD_COLUMNS))


@torch.no_grad()
def render_hits_shuffle(sscene: ShardedScene, origins: torch.Tensor, dirs: torch.Tensor,
                        mesh: Mesh, impl: str = "auto"):
    """Ragged all-to-all ray shuffle: each ray goes only to the shards whose
    root box it enters, is traced there once, and its per-shard results come
    back by the reverse exchange; the origin rank folds a (t, shard) minimum,
    the tie rule of the all-gather combine.

    Route by the (R, S) slab test; bucket the (shard, ray) pairs by
    destination with one sort of ``s * R + ray`` keys; all-gather the S x S
    sizes matrix over tp and read it to the host (the split sizes of both
    exchanges: the engine's only host read besides the shard's count);
    exchange rays forward, trace the received rows, exchange the payloads
    back; fold by scatter-min of t, then of the pair row.

    Exactness: a triangle's inflated box lies inside its shard's root box,
    so a ray with a hit in shard s enters s's box (the traversal's own root
    test), and routing by box overlap loses no hit.  Imbalance costs time,
    never correctness.  Returns this rank's rows (``ray_block(mesh, R,
    ("dp", "tp"))``) of the payload tuple of `render_hits_sharded`;
    ``mesh.copies_sent`` grows by the rows this rank sent."""
    S = mesh.shape["tp"]
    _check_engine(sscene, origins, dirs, mesh, mesh.shape["dp"] * S)
    R = origins.shape[0] // (mesh.shape["dp"] * S)
    K = S * R  # the most pairs a rank can send: every ray to every shard
    if K >= 1 << 24:
        raise ValueError(f"S * R = {K} pairs: the pair keys need S * R < 2^24")
    me = mesh.get_local_rank("tp")
    rows = ray_block(mesh, origins.shape[0], ("dp", "tp"))
    scene_l, bvh, gtri = _shard(sscene, me, mesh)
    o, d = origins[rows], dirs[rows]
    dev = o.device

    # 1. route: which shards does each ray enter?
    overlap = _entry_t(o, d, sscene.range_min, sscene.range_max) < torch.inf  # (R, S)
    # 2. bucket by destination: pairs sorted by s * R + ray, ray-ordered within
    ray_ids = torch.arange(R, dtype=torch.int32, device=dev)
    shard_ids = torch.arange(S, dtype=torch.int32, device=dev)
    pair_key = torch.where(overlap.T, shard_ids[:, None] * R + ray_ids[None, :],
                           torch.iinfo(torch.int32).max).reshape(K)
    pair_key = torch.sort(pair_key).values
    dest_counts = overlap.sum(dim=0, dtype=torch.int32)                      # (S,)
    sizes = _host_read(mesh, _all_gather(dest_counts, mesh, "tp"))  # [src][dst]
    send_sizes = sizes[me]
    recv_sizes = [sizes[src][me] for src in range(S)]
    sent, received = sum(send_sizes), sum(recv_sizes)
    mesh.copies_sent += sent
    r_of = (pair_key[:sent] % R).to(torch.int64)
    send = take_rows(torch.cat([o, d], dim=1), r_of)                         # (sent, 6)
    recv = _ragged_a2a(send, torch.empty((received, 6), dtype=torch.float32, device=dev),
                       send_sizes, recv_sizes, mesh.get_group("tp"))

    # 3. trace the received rays against the local shard
    res = _trace_packed(scene_l, bvh, gtri, recv[:, 0:3], recv[:, 3:6], impl)

    # 4. reverse exchange: each sent copy's payload comes home, in send order;
    #    one spare zero row past them serves rays that sent nothing
    back = torch.zeros((sent + 1, 9), dtype=torch.int32, device=dev)
    back = _ragged_a2a(res, back, recv_sizes, send_sizes, mesh.get_group("tp"))

    # 5. fold: per-ray min t, ties to the lowest pair row (= lowest shard)
    t_rows = back[:sent, 0].view(torch.float32)
    t_best = torch.full((R,), C.MAX_FLOAT, dtype=torch.float32, device=dev)
    t_best = t_best.scatter_reduce(0, r_of, t_rows, "amin")
    is_best = t_rows == t_best[r_of]
    none = torch.iinfo(torch.int64).max
    pair_rows = torch.arange(sent, dtype=torch.int64, device=dev)
    win = torch.full((R,), none, dtype=torch.int64, device=dev).scatter_reduce(
        0, r_of, torch.where(is_best, pair_rows, none), "amin")
    has = win < none
    sel = back[torch.where(has, win, sent)]                  # row ``sent`` is zeros
    _t, g, u, v, uv, normal = _unpack(sel, _PAYLOAD_COLUMNS)
    return t_best, g, u, v, uv, normal


@torch.no_grad()
def render_hits_dp(scene: Scene, bvh: Bvh, origins, dirs, mesh: Mesh,
                   impl: str = "auto") -> HitRecord:
    """Ray data parallelism: scene and BVH replicated, rays split over dp.
    Exactly the single-device trace of this rank's rows
    (``ray_block(mesh, R, "dp")``); ``impl`` as in `render_hits_sharded`."""
    if origins.shape[0] % mesh.shape["dp"]:
        raise ValueError(f"{origins.shape[0]} rays do not divide dp={mesh.shape['dp']}")
    _on_mesh(mesh, origins, dirs, scene.morton)
    rows = ray_block(mesh, origins.shape[0], "dp")
    return dispatch.trace_rays(scene, bvh, origins[rows].contiguous(),
                               dirs[rows].contiguous(), impl=impl)
