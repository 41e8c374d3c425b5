"""Binary-record (BVH2) traversal: record table, the CUDA kernel's wrapper,
and the plain PyTorch version of the same traversal.

Counterpart of ``unitysimpleraytracing_tpu/ops/trace_pallas.py``.  Child-pair
DFS with ordering and culling: each popped record carries BOTH children's
AABBs; the ray slab-tests the two child boxes, intersects leaf children in
place, and pushes internal children far-then-near, so the near subtree is
explored first.  Two exact refinements over the reference's blind DFS
(Raytracing.compute:129-176):

- **t-culling**: a child is live for a ray only when its slab entry distance
  satisfies ``tmin < t_cur``.  Any triangle inside the child box hits at
  ``t >= tmin`` (the hit point lies in the box, and triangle AABBs are
  inflated by 1e-3 — MeshBufferContainer.cs:55-63 — which dwarfs slab
  rounding for scene extents ≲ 8e3; beyond that the packed boxes are
  widened), so a culled subtree can never win the strict ``t_new < t_cur``
  compare.  Identical hit set, far fewer visits.
- **near-child-first ordering** by the record's build-time split axis against
  the RAY'S OWN direction sign.  Ordering can flip which of two EXACTLY-tied
  triangles (shared edges) is reported — the parity contract bounds those
  ties.

The leaf child's stored box is the triangle's inflated AABB, so the slab gate
already IS the reference's leaf AABB pre-test (Raytracing.compute:91); the
leaf record then only needs the 9 vertex scalars.

**Record = 32 f32 slots** (128 bytes), one ``(cap, 32)`` float32 table in
global memory, bit-identical to the JAX package's ``pack_tables(pack=1)``:

      0-5   left child AABB (min.xyz, max.xyz)
      6-11  right child AABB
      12    lmeta = left_idx  + is_leaf<<20                 (exact f32 int)
      13    rmeta = right_idx + is_leaf<<20 + split_axis<<21
      14-22 left-leaf triangle vertices a.xyz b.xyz c.xyz (0 if internal)
      23-31 right-leaf triangle vertices

The 20-bit ids are this engine's envelope: capacity < 2^20.  The JAX
package's ``pack`` = 2 or 4 records per row are reshapes of the same bytes;
`pack_tables` returns them for parity, but the traversal takes the flat
``(cap, 32)`` form only, so a table's shape says what it is (64 slots per row
is always a BVH4 table, `ops/trace_bvh4`).

Kernel note.  `traverse_bvh2` launches ``csrc/trace_bvh2.cu``, the
hand-written CUDA kernel that replaces the TPU kernel
``ops/trace_pallas.py::_make_kernel``: one thread per ray with a private
64-entry stack, each ray ordering the two children by its own direction sign
(the TPU kernel shared one stack and one sign vote per packet of rays), the
any-hit mode leaving the loop at the first accepted hit.  What sets its pace
is the walk's chain of dependent steps (stack → record → slab tests → next
record), not bytes: a warm L2 runs it within 1 % of a cold one.  So the near
child, popped straight back on most steps, stays in a register as the next
record instead of going through the stack, and a record that tests a leaf
child reads both triangles as four 16-byte loads.  A binary record advances
one tree level per fetch where a BVH4 record advances two, so it pops 1.7 to
2 times as many records, each half the size, and is still the faster of the
two.  On an H100 80GB HBM3 at 700 W ``benchmarks/kernel_ab.py`` measured
0.19 ms for 2,027,520 camera rays over the default tree's 261,120 records
(7.07 records per ray) against a 0.030 ms bound (bytes: rays in, hits out,
each distinct record once), and the BVH4 kernel slower on every scene it
times (``--cases k2_vs_k1``).
`traverse_bvh2_plain` is the same traversal in plain PyTorch with the same
arithmetic order; the CPU tests use it and ``chip_smoke.py`` holds the kernel
against it bit for bit.
"""
from __future__ import annotations

import ctypes
import weakref

import torch

from unitysimpleraytracing_tpu_torch.core.types import Bvh, Scene
from unitysimpleraytracing_tpu_torch.ops import trace_bvh4
from unitysimpleraytracing_tpu_torch.utils import kernel_build

_SLOTS = 32
_IDX_BITS = 20
_IDX_MASK = (1 << _IDX_BITS) - 1
# Capacity envelope of the meta packing (ids below 2^20).
MAX_CAPACITY = (1 << _IDX_BITS) - 1
KERNEL_NAME = "trace_bvh2"
# trace_rays pads ray batches to whole warps.
RAY_MULTIPLE = 32

# id(bvh) -> (weakref(bvh), weakref(scene), table).  Keyed by id with a
# weakref finalizer evicting the entry when the Bvh dies; the stored weakrefs
# are validated on lookup so a recycled id can never alias stale geometry.
_TABLE_CACHE: dict = {}


def auto_pack(capacity: int) -> int:
    """Records per table row for a capacity.  The JAX package chooses 1, 2 or
    4 by what fits the TPU's fast memory; this card reads records from global
    memory with one fetch form, so the answer is always 1."""
    return 1


def _resolve_pack(capacity: int, flat: bool | None, pack: int | None) -> int:
    """Layout resolution as in the JAX package: explicit ``pack`` wins;
    legacy ``flat`` maps True → 1 and False → 4; None → `auto_pack`."""
    if pack is None:
        pack = (1 if flat else 4) if flat is not None else auto_pack(capacity)
    if pack not in (1, 2, 4) or capacity % pack:
        raise ValueError(f"pack must be 1, 2 or 4 and divide the capacity, got {pack}")
    return pack


@torch.no_grad()
def pack_tables(scene: Scene, bvh: Bvh, pack: int = 1) -> torch.Tensor:
    """Flatten scene+BVH into ONE record table (layout in the module doc).

    Child boxes are the child NODE AABBs for internal children and the
    triangle's inflated AABB for leaf children (pre-resolving the leaf
    indirection Raytracing.compute:156,172 AND the leaf AABB pre-test box
    :91); *_idx is the child node id for internal children and the TRIANGLE
    id (sorted_tri[leaf]) for leaf children.

    ``pack`` = records per row: 1 → (cap, 32); 2/4 → the same bytes viewed as
    (cap/pack, pack*32), record k at row k//pack, slot base (k%pack)*32.  The
    traversal takes the ``pack=1`` form (``table.reshape(-1, 32)``).
    """
    cap = bvh.capacity
    pack = _resolve_pack(cap, None, pack)
    if cap > MAX_CAPACITY:
        raise ValueError("meta packing needs indices < 2^20 (f32-exact)")

    lc = bvh.left.clamp(0, cap - 1).to(torch.int64)
    rc = bvh.right.clamp(0, cap - 1).to(torch.int64)
    sorted_tri = bvh.sorted_tri.to(torch.int64)
    left_idx = torch.where(bvh.left_is_leaf, sorted_tri[lc], lc)
    right_idx = torch.where(bvh.right_is_leaf, sorted_tri[rc], rc)
    lmeta = left_idx + (bvh.left_is_leaf.to(torch.int64) << _IDX_BITS)
    rmeta = (
        right_idx
        + (bvh.right_is_leaf.to(torch.int64) << _IDX_BITS)
        + (bvh.split_axis.to(torch.int64).clamp(0, 2) << (_IDX_BITS + 1))
    )

    def child_box(child, is_leaf, tri_of_child):
        m = is_leaf[:, None]
        return (
            torch.where(m, scene.aabb_min[tri_of_child], bvh.node_aabb_min[child]),
            torch.where(m, scene.aabb_max[tri_of_child], bvh.node_aabb_max[child]),
        )

    lmin, lmax = child_box(lc, bvh.left_is_leaf, left_idx)
    rmin, rmax = child_box(rc, bvh.right_is_leaf, right_idx)

    # Cull soundness beyond the ~8e3 scene-extent bound (module doc): larger
    # scenes get the packed child boxes widened by 4e-6 per unit of excess
    # extent so the margin dominates slab rounding again.  Widening only
    # loosens the cull and the leaf pre-test gate (extra visits, never lost
    # hits); scenes within the bound widen by exactly 0.
    root = torch.maximum(
        bvh.node_aabb_min[0].abs().max(), bvh.node_aabb_max[0].abs().max()
    )
    widen = torch.clamp(root - 8192.0, min=0.0) * 4e-6

    t = scene.triangles

    def leaf_verts(is_leaf, tri):
        m = is_leaf[:, None]
        return (
            torch.where(m, t.a[tri], 0.0),
            torch.where(m, t.b[tri], 0.0),
            torch.where(m, t.c[tri], 0.0),
        )

    nodes = torch.cat(
        [
            lmin - widen, lmax + widen, rmin - widen, rmax + widen,
            lmeta.to(torch.float32)[:, None],
            rmeta.to(torch.float32)[:, None],
            *leaf_verts(bvh.left_is_leaf, left_idx),
            *leaf_verts(bvh.right_is_leaf, right_idx),
        ],
        dim=1,
    )  # (cap, 32)
    return nodes if pack == 1 else nodes.reshape(cap // pack, pack * _SLOTS)


def table_geometry(tables: torch.Tensor) -> int:
    """Record count of a packed table (the traversal takes one layout)."""
    if tables.ndim != 2 or tables.shape[1] != _SLOTS:
        raise ValueError(
            f"not a (cap, {_SLOTS}) record table: {tuple(tables.shape)} "
            f"(a pack=2|4 view goes in as table.reshape(-1, {_SLOTS}))"
        )
    return tables.shape[0]


def prepare_tables(
    scene: Scene, bvh: Bvh, flat: bool | None = None, pack: int | None = None
) -> torch.Tensor:
    """The ``(cap, 32)`` record table for (scene, bvh), cached per Bvh
    instance: a static scene re-traced every frame must not repay the pack —
    the reference likewise packs once in Awake and only dispatches per frame
    (RaytracingMeshDrawer.cs:76).

    ``flat`` and ``pack`` are the JAX package's layout arguments; they are
    checked as there, but the table comes back flat whatever they say: it is
    the one layout `traverse_bvh2` takes (`pack_tables` gives the views)."""
    _resolve_pack(bvh.capacity, flat, pack)
    key = id(bvh)
    ent = _TABLE_CACHE.get(key)
    if ent is not None and ent[0]() is bvh and ent[1]() is scene:
        return ent[2]
    tables = pack_tables(scene, bvh)
    bvh_ref = weakref.ref(bvh, lambda _r, _k=key: _TABLE_CACHE.pop(_k, None))
    _TABLE_CACHE[key] = (bvh_ref, weakref.ref(scene), tables)
    return tables


# --------------------------------------------------------------------------
# Traversal
# --------------------------------------------------------------------------


def _check_inputs(table, origins, dirs, t_init, anyhit_thresh):
    table_geometry(table)
    trace_bvh4.check_ray_batch(table, origins, dirs, t_init, anyhit_thresh)


def _load_kernel():
    """The kernel's C entry point, built by nvcc on first use."""
    lib = kernel_build.load_kernel_library(KERNEL_NAME)
    fn = lib.trace_bvh2_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


@torch.no_grad()
def traverse_bvh2(
    table: torch.Tensor,
    origins: torch.Tensor,
    dirs: torch.Tensor,
    t_init: torch.Tensor | None = None,
    anyhit_thresh: torch.Tensor | None = None,
    count_steps: bool = False,
):
    """Binary-record nearest-hit traversal over (R, 3) rays (see module doc).

    ``table`` is a `prepare_tables` result.  ``t_init`` (R,) seeds the
    running best — hits at or beyond it are pruned AND rejected exactly as if
    a previous traversal had already found a hit there; ``anyhit_thresh``
    (R,), where positive, retires a ray at its first accepted hit strictly
    below the threshold with t collapsed to 0 (the occlusion boolean
    ``hit & (t < thresh)`` is what is specified).  Returns a HitRecord, or
    ``(HitRecord, steps)`` with ``count_steps`` — steps (R,) int32 counts the
    records each ray popped.

    On CUDA tensors this launches the hand-written kernel on the current
    stream without synchronising, or raises; it never gives way to the plain
    version.  On CPU tensors it runs `traverse_bvh2_plain`.
    ``traverse_bvh2.launches`` counts kernel launches.
    """
    _check_inputs(table, origins, dirs, t_init, anyhit_thresh)
    if origins.device.type == "cpu":
        return traverse_bvh2_plain(
            table, origins, dirs, t_init, anyhit_thresh, count_steps
        )
    hits, steps = trace_bvh4.launch_traversal(
        _load_kernel(), KERNEL_NAME, table, origins, dirs, t_init, anyhit_thresh, count_steps
    )
    traverse_bvh2.launches += 1
    return (hits, steps) if count_steps else hits


traverse_bvh2.launches = 0


def _slab(box, o, inv, t):
    """One child box (A, 6) against the rays, with the running t as it was at
    the pop: D3D min/max, accept ``tmax > tmin && tmax > 0 && tmin < t``."""
    t1 = (box[:, 0:3] - o) * inv
    t2 = (box[:, 3:6] - o) * inv
    lo = torch.fmin(t1, t2)
    hi = torch.fmax(t1, t2)
    tmin = torch.fmax(lo[:, 0], torch.fmax(lo[:, 1], lo[:, 2]))
    tmax = torch.fmin(hi[:, 0], torch.fmin(hi[:, 1], hi[:, 2]))
    return (tmax > tmin) & (tmax > 0) & (tmin < t)


def _plain_step(table, o, d, inv, thr, t, tri, u, v, stack, sp, steps, work):
    """One pop for every still-active ray of the working set; in place on
    ``stack``, returns the updated per-ray state.  Same operations in the
    same order as one iteration of the CUDA kernel's loop."""
    active = sp > 0
    spm1 = torch.clamp(sp - 1, min=0)
    k = torch.gather(stack, 1, spm1[:, None])[:, 0].to(torch.int64)
    k = torch.where(active, k, 0)
    rec = table[k]  # (A, 32)
    steps = steps + active

    # Both slab tests see the running t as it was at the pop.
    hit_l = _slab(rec[:, 0:6], o, inv, t) & active
    hit_r = _slab(rec[:, 6:12], o, inv, t) & active

    m = rec[:, 12:14].to(torch.int32)  # exact: metas are integers < 2^24
    lmi, rmi = m[:, 0], m[:, 1]
    left_idx = lmi & _IDX_MASK
    right_idx = rmi & _IDX_MASK
    lleaf = (lmi >> _IDX_BITS) == 1
    rleaf = ((rmi >> _IDX_BITS) & 1) == 1
    axis = rmi >> (_IDX_BITS + 1)

    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    # Leaf children, left then right: Möller–Trumbore on the embedded
    # vertices, gated by the child's own slab mask.
    for base, gate, idx in ((14, hit_l & lleaf, left_idx), (23, hit_r & rleaf, right_idx)):
        vt = rec[:, base:base + 9]
        ax, ay, az = vt[:, 0], vt[:, 1], vt[:, 2]
        e1x, e1y, e1z = vt[:, 3] - ax, vt[:, 4] - ay, vt[:, 5] - az
        e2x, e2y, e2z = vt[:, 6] - ax, vt[:, 7] - ay, vt[:, 8] - az
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
        accept = gate & ~reject & (tn < t)
        t = torch.where(accept, tn, t)
        tri = torch.where(accept, idx, tri)
        u = torch.where(accept, uu, u)
        v = torch.where(accept, vv, v)

    if work is not None:
        work["visited"][k[active]] = True
        work["leaf_tests"] += (hit_l & lleaf).sum() + (hit_r & rleaf).sum()
        work["leaf_records"] = work.get("leaf_records", 0) + (
            (hit_l & lleaf) | (hit_r & rleaf)).sum()

    # Any-hit: retire at the first accepted hit below a positive threshold.
    collapsed = active & (thr > 0) & (t < thr)
    t = torch.where(collapsed, 0.0, t)

    # Push internal children far then near, by this ray's own direction sign
    # on the record's split axis ("left is near" iff the ray travels in +axis).
    l_near = torch.where(axis == 0, dx > 0, torch.where(axis == 1, dy > 0, dz > 0))
    push_l = hit_l & ~lleaf
    push_r = hit_r & ~rleaf
    both = push_l & push_r
    first = torch.where(
        both,
        torch.where(l_near, right_idx, left_idx),
        torch.where(push_l, left_idx, right_idx),
    )
    second = torch.where(l_near, left_idx, right_idx)
    new_sp = spm1
    for ii, pp in ((first, push_l | push_r), (second, both)):
        rows = pp.nonzero(as_tuple=True)[0]
        stack[rows, new_sp[rows]] = ii[rows]
        new_sp = new_sp + pp
    sp = torch.where(active, new_sp, sp)
    sp = torch.where(collapsed, 0, sp)
    return t, tri, u, v, sp, steps


@torch.no_grad()
def traverse_bvh2_plain(
    table: torch.Tensor,
    origins: torch.Tensor,
    dirs: torch.Tensor,
    t_init: torch.Tensor | None = None,
    anyhit_thresh: torch.Tensor | None = None,
    count_steps: bool = False,
    work: dict | None = None,
):
    """Plain PyTorch version of `traverse_bvh2` (same signature, any device):
    a lock-step batched per-ray DFS over the same table — per-ray stack rows,
    one pop per still-active ray per step, masked updates — with the kernel's
    per-ray near/far order and arithmetic order (the loop is
    `trace_bvh4.plain_traverse`).

    ``work`` (this version only): a dict that receives what the walk needed —
    ``records_visited`` (distinct records popped by any ray), ``leaf_tests``
    (triangle tests run) and ``leaf_records`` (popped records that tested a
    leaf child, each of which the kernel reads whole) — the data-dependent
    terms of the kernel's roofline bound and loaded bytes.  The kernel walks
    the same records."""
    _check_inputs(table, origins, dirs, t_init, anyhit_thresh)
    return trace_bvh4.plain_traverse(
        _plain_step, 2, table, origins, dirs, t_init, anyhit_thresh, count_steps, work
    )
