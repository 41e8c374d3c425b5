"""Wide-record (BVH4) traversal: record tables, the CUDA kernel's wrapper,
and the plain PyTorch version of the same traversal.

Counterpart of ``unitysimpleraytracing_tpu/ops/trace_pallas4.py``.  One
4-child record per stack entry, built by collapsing Karras pairs — one record
fetch + four slab tests advance a ray TWO tree levels.

- **Node set**: internal Karras nodes at EVEN depth (root = 0).  Each BVH4
  node X expands its two BVH2 children in place: an internal child
  contributes its OWN two children (X's grandchildren) as entries, a leaf
  child contributes itself, the vacant slot is an inert EMPTY entry
  (inverted box → slab always fails; leaf bit + zero verts → det==0 reject).
  Internal entries are even-depth nodes again, so traversal only ever sees
  BVH4 nodes.  The table is allocated at the ACTUAL compacted count.
- **Record = 64 f32 slots** (4 child boxes 24, 4 metas 4, 4×9 embedded leaf
  triangles 36 — stored PRE-DIFFERENCED as (a, e1=b−a, e2=c−a); the f32
  subtraction moves from the traversal to pack time bit-unchanged).  One
  layout: a ``(cap4, 64)`` float32 table in global memory.
- **Meta slot** (f32-exact, < 2^24): ``idx + is_leaf<<21 + axis<<22`` where
  idx is the entry's BVH4 node id (internal) or triangle id (leaf); meta0's
  axis is X's own split axis (orders the two pairs), meta1/meta2's axes are
  X's left/right BVH2 children's split axes (order within each pair).  The
  21-bit ids are the single-tree envelope of this path.

Traversal order within a record: nearest-first over (pair by X's axis) ×
(entry by the pair's axis) against the RAY'S OWN direction signs, pushed in
reverse; the strict-< hit keep makes order affect only exact-t ties.

Kernel note.  `traverse_bvh4` launches ``csrc/trace_bvh4.cu``, the
hand-written CUDA kernel that replaces the TPU kernel
``ops/trace_pallas4.py::_make_kernel4``: one thread per ray with a private
64-entry stack, the record it pops next kept in a register.  What bounds it
on this card is the walk's chain of dependent steps (stack, record, slab
tests, next record), not bytes, L2 or one fetch's latency: the bytes it loads
arrive at about 4.5 TB/s from the caches, a warm L2 gains nothing over a cold
one, and the lanes of a 32-ray warp are about 74 % busy.  Its roofline bound
is the larger of bytes (rays in, hits out, each distinct record once) and
float32 operations at the no-FMA rate: on an H100 80GB HBM3 at 700 W,
2,027,520 primary rays over the default tree of 260,642 triangles take about
0.22 ms against a 0.030 ms bound (``chip_smoke.py``; ``PERF.md`` has the
first kernel's time beside it, from ``benchmarks/kernel_ab.py``).
`traverse_bvh4_plain` is the same traversal in plain PyTorch with the same
arithmetic order; the CPU tests use it and ``chip_smoke.py`` holds the kernel
against it bit for bit, records popped per ray included.

Compressed records (`compress_tables4`).  A ``(cap4, 52)`` table stores each
entry's box as three float32 slots, each one axis's (min, max) as a bf16
pair, rounded outward (min down, max up), so the stored box contains the
float32 box: 208 bytes a record instead of 256.  `traverse_bvh4` takes it
too: on the card it launches the same kernel's second entry point (the
counterpart of ``_make_kernel4(compress=True)``), which unpacks each pair
exactly (``w & 0xFFFF0000`` and ``w << 16`` read as float32) and then walks
as above; `traverse_bvh4_plain` unpacks the same way.  A widened box only
admits extra slab passes, which the strict-< triangle fold rejects, with one
semantic edge: a triangle entirely BEHIND the ray origin whose true box has
tmax within the bf16 rounding of 0 can now reach the (t > 0-free) triangle
test, where the reference would have culled it at the box stage
(Raytracing.compute:86).

Reference mapping: same acceptance contract as Raytracing.compute:37-103
(slab ``tmax>tmin && tmax>0``, Möller–Trumbore det/u/v rejects, no t>0 test).
"""
from __future__ import annotations

import ctypes
import weakref

import torch

from unitysimpleraytracing_tpu_torch import constants as C
from unitysimpleraytracing_tpu_torch.core.types import Bvh, HitRecord, Scene
from unitysimpleraytracing_tpu_torch.ops import lbvh
from unitysimpleraytracing_tpu_torch.utils import kernel_build

_SLOTS4 = 64
_SLOTS4C = 52  # compressed: 12 bf16-pair box slots, 4 metas, 36 vertex slots
_IDX_BITS = 21
_IDX_MASK = (1 << _IDX_BITS) - 1
KERNEL_NAME = "trace_bvh4"
# trace_rays pads ray batches to whole warps.
RAY_MULTIPLE = 32

# id(bvh.left) -> (weakref(left), mask, new_id, count, plans).  Keyed by the
# TOPOLOGY tensor's identity, not the Bvh object's: refit_bvh replaces only
# the box fields, so a refit-per-frame loop reuses the even-depth membership
# (the pointer-doubling depth pass is the expensive part of repacking) and
# the cap4 -> (src_idx, metas) pack plans.
_TOPO_CACHE: dict = {}
# id(bvh) -> (weakref(bvh), weakref(scene), table)
_TABLE4_CACHE: dict = {}


def _node_mask_compute(bvh: Bvh):
    cap = bvh.left.shape[0]
    dev = bvh.left.device
    ids = torch.arange(cap, dtype=torch.int32, device=dev)
    valid = ids < bvh.count - 1
    # Parent links may be absent (-1-filled non-diagnostic build): recompute.
    iparent, _ = lbvh.parent_links(
        bvh.left, bvh.right, bvh.left_is_leaf, bvh.right_is_leaf, valid
    )
    depth = lbvh.compute_depths(iparent, bvh.count)
    mask = valid & (depth % 2 == 0)
    new_id = torch.cumsum(mask, dim=0, dtype=torch.int32) - 1
    return mask, new_id


def _node_mask_cached(bvh: Bvh):
    """(mask, new_id, count): count is the host int record count (cached —
    it costs a device→host sync, which a refit-per-frame loop must not
    repay)."""
    key = id(bvh.left)
    ent = _TOPO_CACHE.get(key)
    if ent is not None and ent[0]() is bvh.left:
        return ent[1], ent[2], ent[3]
    mask, new_id = _node_mask_compute(bvh)
    count = int(mask.sum())
    ref = weakref.ref(bvh.left, lambda _r, _k=key: _TOPO_CACHE.pop(_k, None))
    _TOPO_CACHE[key] = (ref, mask, new_id, count, {})
    return mask, new_id, count


def bvh4_node_mask(bvh: Bvh):
    """(mask, new_id): even-depth internal nodes and their compacted ids.

    Cached per topology (identity of the child-link tensor), so refit-only
    rebuilds skip the depth chase."""
    mask, new_id, _ = _node_mask_cached(bvh)
    return mask, new_id


def _pack_plan4(bvh: Bvh, mask, new_id, cap4: int):
    """Topology-only half of the table pack: per-record-row entry SOURCE
    indices into the unified geometry source array (_apply_plan4's ``S``)
    plus the constant meta columns.

    A deforming mesh changes boxes and vertices but not the tree, so this
    plan is computed once per topology and cached; the per-frame repack
    replays only the geometry gathers."""
    cap = bvh.capacity
    dev = bvh.left.device
    left, right = bvh.left.to(torch.int64), bvh.right.to(torch.int64)
    sorted_tri = bvh.sorted_tri.to(torch.int64)
    new_id64 = new_id.to(torch.int64)
    split_axis = bvh.split_axis.to(torch.int64)

    Lc = left.clamp(0, cap - 1)
    Rc = right.clamp(0, cap - 1)
    Ll, Rl = bvh.left_is_leaf, bvh.right_is_leaf

    def grand(c):
        """BVH2 children of node c (as entry candidates)."""
        return (
            left[c].clamp(0, cap - 1), bvh.left_is_leaf[c],
            right[c].clamp(0, cap - 1), bvh.right_is_leaf[c],
        )

    LL, LLl, LR, LRl = grand(Lc)
    RL, RLl, RR, RRl = grand(Rc)

    def entry(node2, is_leaf, present):
        """Source row + meta fields for one entry: leaf entries read row
        cap+tri (triangle geometry), internal entries read row node2 (node
        boxes), absent entries read the inert EMPTY row 2·cap."""
        tri = sorted_tri[node2]
        src = torch.where(is_leaf, cap + tri, node2)
        src = torch.where(present, src, 2 * cap)
        idx = torch.where(is_leaf, tri, new_id64[node2])
        idx = torch.where(present, idx, 0)
        leaf_bit = torch.where(present, is_leaf.to(torch.int64), 1)
        return src, idx, leaf_bit

    true_ = torch.ones((cap,), dtype=torch.bool, device=dev)
    e0 = entry(torch.where(Ll, Lc, LL), Ll | LLl, true_)
    e1 = entry(LR, LRl, ~Ll)
    e2 = entry(torch.where(Rl, Rc, RL), Rl | RLl, true_)
    e3 = entry(RR, RRl, ~Rl)

    # Near-child ordering axes: record's own split axis + each pair's axis.
    ax_self = split_axis.clamp(0, 2)
    ax_l = torch.where(Ll, 0, split_axis[Lc].clamp(0, 2))
    ax_r = torch.where(Rl, 0, split_axis[Rc].clamp(0, 2))
    axes = (ax_self, ax_l, ax_r, torch.zeros_like(ax_self))

    srcs = torch.stack([e[0] for e in (e0, e1, e2, e3)], dim=1)  # (cap, 4)
    metas = torch.stack(
        [
            (e[1] + (e[2] << _IDX_BITS) + (ax << (_IDX_BITS + 1))).to(torch.float32)
            for e, ax in zip((e0, e1, e2, e3), axes)
        ],
        dim=1,
    )  # (cap, 4)

    # Compact mask rows to their new ids (record-table row r reads BVH2 node
    # rows[r]); padding rows replicate node 0's entries — never referenced.
    rows = torch.zeros((cap4,), dtype=torch.int64, device=dev)
    rows[new_id64[mask]] = mask.nonzero(as_tuple=True)[0]
    return srcs[rows], metas[rows]  # (cap4, 4) each


def _apply_plan4(scene: Scene, bvh: Bvh, src_idx, metas):
    """Geometry-only half of the table pack: build the unified source array
    and gather each entry's 15 slots (6 box + 9 pre-differenced verts) by the
    plan's source rows."""
    cap = bvh.capacity
    dev = bvh.left.device
    t = scene.triangles
    BIG = 3.0e38
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
                [torch.full((1, 3), BIG, **f32), torch.full((1, 3), -BIG, **f32),
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
def pack_tables4(
    scene: Scene, bvh: Bvh, cap4: int | None = None, mask=None, new_id=None
) -> torch.Tensor:
    """Flatten scene+BVH into the 4-child record table (see module doc).

    Two-stage: a topology-only PLAN (_pack_plan4 — entry sources + metas,
    cached per topology) applied to the current geometry (_apply_plan4 —
    4 grouped gathers).  A refit-per-frame animation loop therefore repays
    only the apply stage.

    ``cap4`` is the record count (defaults to the worst-case (2·cap+1)/3
    bound; `prepare_tables4` passes the actual even-depth node count)."""
    cap = bvh.capacity
    if cap4 is None:
        cap4 = (2 * cap) // 3 + 2
    if cap4 >= (1 << _IDX_BITS):
        raise ValueError("meta packing needs node ids < 2^21")
    if cap >= (1 << _IDX_BITS):
        raise ValueError("meta packing needs triangle ids < 2^21")

    if mask is None:
        mask, new_id = bvh4_node_mask(bvh)
    ent = _TOPO_CACHE.get(id(bvh.left))
    if ent is not None and ent[0]() is bvh.left:
        plan = ent[4].get(cap4)
        if plan is None:
            plan = ent[4][cap4] = _pack_plan4(bvh, mask, new_id, cap4)
    else:
        plan = _pack_plan4(bvh, mask, new_id, cap4)
    return _apply_plan4(scene, bvh, *plan)


@torch.no_grad()
def compress_tables4(table: torch.Tensor) -> torch.Tensor:
    """(cap4, 64) record table → (cap4, 52) COMPRESSED table, bit-identical
    to the JAX package's ``compress_tables4``: each entry's six box floats
    become three float32 slots, each packing (min, max) of one axis as a
    bf16 pair (min in the high 16 bits, max in the low).

    Rounding is DIRECTED, so the stored box always contains the float32 box
    (min rounded down, max rounded up); the module doc gives the one
    semantic edge.  Float32 denormals are rounded outward too, where XLA
    flushes them to zero in its sign test (a negative denormal min is
    truncated toward zero there); no packed box holds one, because triangle
    boxes are inflated by 1e-3.  Layout: slots 0-11 packed boxes (entry-major, axes x, y,
    z), 12-15 metas, 16-51 vertices.  Worked on int32 views (the bit
    patterns of the uint32 arithmetic), because torch has few uint32
    operations."""
    if table.ndim != 2 or table.shape[1] != _SLOTS4 or table.dtype != torch.float32:
        raise ValueError(f"not a float32 (cap4, {_SLOTS4}) record table: "
                         f"{table.dtype} {tuple(table.shape)}")
    bits = table.contiguous().view(torch.int32)
    hi_mask = -65536  # 0xFFFF0000

    def rounded(b, v, bump_where):
        """The bf16 pattern (in the high 16 bits) next to v toward the side
        ``bump_where`` selects: truncation, plus one bf16 step where it
        moved v the wrong way."""
        bump = bump_where(v) & ((b & 0xFFFF) != 0)
        return (b & hi_mask) + torch.where(bump, 1 << 16, 0).to(torch.int32)

    boxes = []
    for e in range(4):
        lo_b, hi_b = bits[:, 6 * e:6 * e + 3], bits[:, 6 * e + 3:6 * e + 6]
        lo_v, hi_v = table[:, 6 * e:6 * e + 3], table[:, 6 * e + 3:6 * e + 6]
        lo16 = rounded(lo_b, lo_v, lambda v: v < 0)       # largest bf16 <= min
        hi16 = (rounded(hi_b, hi_v, lambda v: v > 0) >> 16) & 0xFFFF  # smallest >= max
        boxes.append(lo16 | hi16)
    return torch.cat(boxes + [bits[:, 24:]], dim=1).view(torch.float32)


def table_geometry(tables: torch.Tensor) -> int:
    """Record count of a packed table: ``(cap4, 64)`` records, or
    ``(cap4, 52)`` compressed ones (`compress_tables4`)."""
    if tables.ndim != 2 or tables.shape[1] not in (_SLOTS4, _SLOTS4C):
        raise ValueError(
            f"not a (cap4, {_SLOTS4}) or compressed (cap4, {_SLOTS4C}) record table: "
            f"{tuple(tables.shape)}")
    return tables.shape[0]


def prepare_tables4(scene: Scene, bvh: Bvh) -> torch.Tensor:
    """BVH4 record table for (scene, bvh), cached per Bvh instance.

    The table is sized to the scene's ACTUAL compacted even-depth node count
    (one device→host read at pack time, at least 1), not the worst-case
    (2n+1)/3 bound."""
    key = id(bvh)
    ent = _TABLE4_CACHE.get(key)
    if ent is not None and ent[0]() is bvh and ent[1]() is scene:
        return ent[2]
    mask, new_id, cap4 = _node_mask_cached(bvh)
    tables = pack_tables4(scene, bvh, cap4=max(cap4, 1), mask=mask, new_id=new_id)
    bvh_ref = weakref.ref(bvh, lambda _r, _k=key: _TABLE4_CACHE.pop(_k, None))
    _TABLE4_CACHE[key] = (bvh_ref, weakref.ref(scene), tables)
    return tables


# --------------------------------------------------------------------------
# Traversal
# --------------------------------------------------------------------------


def check_ray_batch(table, origins, dirs, t_init, anyhit_thresh):
    """Raise on a ray batch a traversal kernel does not take: float32,
    contiguous, one device, (R, 3) rays and (R,) seeds.  Shared by the BVH4
    and the binary-record engines, kernel and plain version alike, so the CPU
    tests exercise the checks the card sees."""
    R = origins.shape[0]
    if R == 0:
        raise ValueError("empty ray batch")
    named = [("table", table, table.shape), ("origins", origins, (R, 3)),
             ("dirs", dirs, (R, 3))]
    if t_init is not None:
        named.append(("t_init", t_init, (R,)))
    if anyhit_thresh is not None:
        named.append(("anyhit_thresh", anyhit_thresh, (R,)))
    for name, x, shape in named:
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != origins.device:
            raise ValueError(f"{name} is on {x.device}, rays are on {origins.device}")


def _check_inputs(table, origins, dirs, t_init, anyhit_thresh):
    table_geometry(table)
    check_ray_batch(table, origins, dirs, t_init, anyhit_thresh)


def _load_kernel(compressed: bool = False):
    """The kernel's C entry point for 64-slot records, or for compressed
    52-slot ones, built by nvcc on first use."""
    lib = kernel_build.load_kernel_library(KERNEL_NAME)
    fn = lib.trace_bvh4c_launch if compressed else lib.trace_bvh4_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def launch_traversal(launch, name, table, origins, dirs, t_init, anyhit_thresh, count_steps):
    """Launch a traversal kernel (the C entry point ``launch`` of
    ``csrc/<name>.cu``; both kernels share one signature) on checked CUDA
    tensors, on the current stream, without synchronising: allocates the
    outputs, raises if the rays are not on a CUDA device or the launch is
    refused.  Returns ``(HitRecord, steps or None)``."""
    if origins.device.type != "cuda":
        raise ValueError(f"unsupported device {origins.device}")
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned")
    R = origins.shape[0]
    dev = origins.device
    out_t = torch.empty((R,), dtype=torch.float32, device=dev)
    out_tri = torch.empty((R,), dtype=torch.int32, device=dev)
    out_u = torch.empty((R,), dtype=torch.float32, device=dev)
    out_v = torch.empty((R,), dtype=torch.float32, device=dev)
    steps = torch.empty((R,), dtype=torch.int32, device=dev) if count_steps else None

    def ptr(x):
        return None if x is None else x.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(
            ptr(table), ptr(origins), ptr(dirs), ptr(t_init), ptr(anyhit_thresh),
            ptr(out_t), ptr(out_tri), ptr(out_u), ptr(out_v), ptr(steps),
            R, stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return HitRecord(t=out_t, tri=out_tri, u=out_u, v=out_v), steps


@torch.no_grad()
def traverse_bvh4(
    table: torch.Tensor,
    origins: torch.Tensor,
    dirs: torch.Tensor,
    t_init: torch.Tensor | None = None,
    anyhit_thresh: torch.Tensor | None = None,
    count_steps: bool = False,
):
    """BVH4 nearest-hit traversal over (R, 3) rays (see module doc).

    ``table`` is a `prepare_tables4` result, or its `compress_tables4`
    form (52 slots a record).  ``t_init`` (R,) seeds the
    running best; ``anyhit_thresh`` (R,), where positive, retires a ray at
    its first accepted hit below the threshold with t collapsed to 0 (the
    occlusion boolean ``hit & (t < thresh)`` is what is specified).
    Returns a HitRecord, or ``(HitRecord, steps)`` with ``count_steps`` —
    steps (R,) int32 counts the records each ray popped.

    On CUDA tensors this launches the hand-written kernel on the current
    stream without synchronising, or raises; it never gives way to the plain
    version.  On CPU tensors it runs `traverse_bvh4_plain`.
    ``traverse_bvh4.launches`` counts launches of the 64-slot kernel,
    ``traverse_bvh4.compressed_launches`` those of the 52-slot one.
    """
    _check_inputs(table, origins, dirs, t_init, anyhit_thresh)
    if origins.device.type == "cpu":
        return traverse_bvh4_plain(
            table, origins, dirs, t_init, anyhit_thresh, count_steps
        )
    compressed = table.shape[1] == _SLOTS4C
    hits, steps = launch_traversal(
        _load_kernel(compressed), KERNEL_NAME, table, origins, dirs, t_init,
        anyhit_thresh, count_steps,
    )
    if compressed:
        traverse_bvh4.compressed_launches += 1
    else:
        traverse_bvh4.launches += 1
    return (hits, steps) if count_steps else hits


traverse_bvh4.launches = 0
traverse_bvh4.compressed_launches = 0

# The plain version checks its stacks and compacts its working set every
# this many steps (each check is one device→host read).
_PLAIN_CHECK_EVERY = 8


def _unpack_record(rec: torch.Tensor):
    """(boxes (A, 4, 6), metas (A, 4) as floats, first vertex slot) of
    popped records, 64-slot or compressed 52-slot.  A compressed slot's
    bf16 pair unpacks exactly: ``w & 0xFFFF0000`` and ``w << 16`` read as
    float32, as the kernel does."""
    if rec.shape[1] == _SLOTS4:
        return rec[:, 0:24].reshape(-1, 4, 6), rec[:, 24:28], 28
    w = rec[:, 0:12].view(torch.int32)
    lo = (w & -65536).view(torch.float32).reshape(-1, 4, 3)
    hi = (w << 16).view(torch.float32).reshape(-1, 4, 3)
    return torch.cat([lo, hi], dim=2), rec[:, 12:16], 16


def _plain_step(table, o, d, inv, thr, t, tri, u, v, stack, sp, steps, work):
    """One pop for every still-active ray of the working set; in place on
    ``stack``, returns the updated per-ray state.  Same operations in the
    same order as one iteration of the CUDA kernel's loop."""
    active = sp > 0
    spm1 = torch.clamp(sp - 1, min=0)
    k = torch.gather(stack, 1, spm1[:, None])[:, 0].to(torch.int64)
    k = torch.where(active, k, 0)
    rec = table[k]  # (A, 64) or compressed (A, 52)
    steps = steps + active

    # Four slab tests against the running t as it was at the pop.
    box, meta, vbase = _unpack_record(rec)
    t1 = (box[:, :, 0:3] - o[:, None, :]) * inv[:, None, :]
    t2 = (box[:, :, 3:6] - o[:, None, :]) * inv[:, None, :]
    lo = torch.fmin(t1, t2)
    hi = torch.fmax(t1, t2)
    tmin = torch.fmax(lo[..., 0], torch.fmax(lo[..., 1], lo[..., 2]))
    tmax = torch.fmin(hi[..., 0], torch.fmin(hi[..., 1], hi[..., 2]))
    hit = (tmax > tmin) & (tmax > 0) & (tmin < t[:, None]) & active[:, None]

    m = meta.to(torch.int32)  # exact: metas are integers < 2^24
    idx = m & _IDX_MASK
    leaf = ((m >> _IDX_BITS) & 1) == 1
    axis = m >> (_IDX_BITS + 1)

    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    for e in range(4):
        vt = rec[:, vbase + 9 * e: vbase + 9 + 9 * e]
        ax, ay, az = vt[:, 0], vt[:, 1], vt[:, 2]
        e1x, e1y, e1z = vt[:, 3], vt[:, 4], vt[:, 5]
        e2x, e2y, e2z = vt[:, 6], vt[:, 7], vt[:, 8]
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        inv_det = 1.0 / det
        tvx, tvy, tvz = ox - ax, oy - ay, oz - az
        uu = (tvx * px + tvy * py + tvz * pz) * inv_det
        qx = tvy * e1z - tvz * e1y
        qy = tvz * e1x - tvx * e1z
        qz = tvx * e1y - tvy * e1x
        vv = (dx * qx + dy * qy + dz * qz) * inv_det
        tn = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        reject = (
            ((det < 1e-8) & (det > -1e-8))
            | ((uu < 0) | (uu > 1))
            | ((vv < 0) | (uu + vv > 1))
        )
        accept = hit[:, e] & leaf[:, e] & ~reject & (tn < t)
        t = torch.where(accept, tn, t)
        tri = torch.where(accept, idx[:, e], tri)
        u = torch.where(accept, uu, u)
        v = torch.where(accept, vv, v)

    if work is not None:
        work["visited"][k[active]] = True
        work["leaf_tests"] += (hit & leaf).sum()

    # Any-hit: retire at the first accepted hit below a positive threshold.
    collapsed = active & (thr > 0) & (t < thr)
    t = torch.where(collapsed, 0.0, t)

    # Push internal entries far-to-near by this ray's own direction signs.
    def near(ax):
        return torch.where(ax == 0, dx > 0, torch.where(ax == 1, dy > 0, dz > 0))

    push = hit & ~leaf
    n_pair, n_l, n_r = near(axis[:, 0]), near(axis[:, 1]), near(axis[:, 2])

    def ordered(a, b, first_is_a):
        return (
            torch.where(first_is_a, idx[:, a], idx[:, b]),
            torch.where(first_is_a, push[:, a], push[:, b]),
            torch.where(first_is_a, idx[:, b], idx[:, a]),
            torch.where(first_is_a, push[:, b], push[:, a]),
        )

    l0i, l0p, l1i, l1p = ordered(0, 1, n_l)
    r0i, r0p, r1i, r1p = ordered(2, 3, n_r)
    s0 = (torch.where(n_pair, l0i, r0i), torch.where(n_pair, l0p, r0p))
    s1 = (torch.where(n_pair, l1i, r1i), torch.where(n_pair, l1p, r1p))
    s2 = (torch.where(n_pair, r0i, l0i), torch.where(n_pair, r0p, l0p))
    s3 = (torch.where(n_pair, r1i, l1i), torch.where(n_pair, r1p, l1p))
    new_sp = spm1
    for ii, pp in (s3, s2, s1, s0):
        rows = pp.nonzero(as_tuple=True)[0]
        stack[rows, new_sp[rows]] = ii[rows]
        new_sp = new_sp + pp
    sp = torch.where(active, new_sp, sp)
    sp = torch.where(collapsed, 0, sp)
    return t, tri, u, v, sp, steps


def plain_traverse(step, max_push, table, origins, dirs, t_init, anyhit_thresh,
                   count_steps, work):
    """The lock-step loop shared by the plain versions of both traversal
    kernels: per-ray stack rows, ``step`` (one pop for every still-active ray
    of the working set, pushing at most ``max_push`` entries) until no ray
    walks; rays that have finished are dropped from the working set from time
    to time, so late steps cost only the rays still walking."""
    if work is not None:
        work["visited"] = torch.zeros(table.shape[0], dtype=torch.bool, device=table.device)
        work["leaf_tests"] = torch.zeros((), dtype=torch.int64, device=table.device)
    R = origins.shape[0]
    dev = origins.device
    f32 = dict(dtype=torch.float32, device=dev)
    out_t = torch.full((R,), C.MAX_FLOAT, **f32) if t_init is None else t_init.clone()
    out_tri = torch.zeros((R,), dtype=torch.int32, device=dev)
    out_u = torch.zeros((R,), **f32)
    out_v = torch.zeros((R,), **f32)
    out_steps = torch.zeros((R,), dtype=torch.int32, device=dev)

    # Working set: the rays still walking (all of them at first).
    ray = torch.arange(R, device=dev)
    o, d = origins, dirs
    inv = 1.0 / dirs
    thr = torch.zeros((R,), **f32) if anyhit_thresh is None else anyhit_thresh
    t, tri, u, v, steps = out_t, out_tri, out_u, out_v, out_steps
    # Slack columns: overflow past the kernel's 64 entries is detected at the
    # next check instead of indexing out of range.
    depth = C.TRAVERSAL_STACK_DEPTH
    stack = torch.zeros(
        (R, depth + max_push * _PLAIN_CHECK_EVERY), dtype=torch.int32, device=dev
    )
    sp = torch.ones((R,), dtype=torch.int64, device=dev)

    it = 0
    while True:
        if it % _PLAIN_CHECK_EVERY == 0:
            active = sp > 0
            n_active = int(active.sum())
            if int(sp.max()) > depth:
                raise RuntimeError("traversal stack overflow (tree too deep)")
            if n_active <= ray.shape[0] // 2:
                out_t[ray], out_tri[ray], out_u[ray], out_v[ray] = t, tri, u, v
                out_steps[ray] = steps
                if n_active == 0:
                    break
                keep = active.nonzero(as_tuple=True)[0]
                ray, o, d, inv, thr = ray[keep], o[keep], d[keep], inv[keep], thr[keep]
                t, tri, u, v, steps = t[keep], tri[keep], u[keep], v[keep], steps[keep]
                stack, sp = stack[keep], sp[keep]
        t, tri, u, v, sp, steps = step(
            table, o, d, inv, thr, t, tri, u, v, stack, sp, steps, work
        )
        it += 1
    if work is not None:
        work["records_visited"] = int(work.pop("visited").sum())
        for name, count in work.items():   # leaf_tests, and the steps' own counters
            if isinstance(count, torch.Tensor):
                work[name] = int(count)

    hits = HitRecord(t=out_t, tri=out_tri, u=out_u, v=out_v)
    return (hits, out_steps) if count_steps else hits


@torch.no_grad()
def traverse_bvh4_plain(
    table: torch.Tensor,
    origins: torch.Tensor,
    dirs: torch.Tensor,
    t_init: torch.Tensor | None = None,
    anyhit_thresh: torch.Tensor | None = None,
    count_steps: bool = False,
    work: dict | None = None,
):
    """Plain PyTorch version of `traverse_bvh4` (same signature, any device):
    a lock-step batched per-ray DFS over the same table — per-ray stack rows,
    one pop per still-active ray per step, masked updates (`plain_traverse`)
    — with the kernel's per-ray near/far order and arithmetic order.

    ``work`` (this version only): a dict that receives what the walk needed —
    ``records_visited`` (distinct records popped by any ray) and
    ``leaf_tests`` (triangle tests run) — the data-dependent terms of the
    kernel's roofline bound.  The kernel walks the same records."""
    _check_inputs(table, origins, dirs, t_init, anyhit_thresh)
    return plain_traverse(
        _plain_step, 4, table, origins, dirs, t_init, anyhit_thresh, count_steps, work
    )
