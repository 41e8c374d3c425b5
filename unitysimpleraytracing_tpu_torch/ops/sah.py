"""Sweep-SAH topology builders: ``build_bvh(..., builder="sah")`` over the
Morton-sorted leaf order and ``builder="sah_free"`` (the default), which also
re-partitions the leaves of every node.

Counterpart of ``unitysimpleraytracing_tpu/ops/sah.py``.  The reference builds
only the Karras radix tree (BVH.compute:94-149), whose splits are Morton bit
boundaries.  Its hit CONTRACT, though, is independent of topology: the
traversal keeps the strict-< nearest intersection, so ANY binary tree over the
same leaves returns the same hit (exact-t ties are the same bounded class the
other engines already accept).  These builders keep the reference's output
while choosing better splits: full sweep SAH (not binned), every candidate
position of every node.

Why the trees drop into the existing machinery unchanged
--------------------------------------------------------
Every node of a top-down split tree over a leaf sequence covers a CONTIGUOUS
range, so the range-query refit (ops/lbvh.refit) applies verbatim.  And any
such tree can be numbered the Karras way — children at (split, split+1) — by
naming each left child after its range's LAST index and each right child
after its range's FIRST index: the two names can never collide, and the n-1
names are exactly {0..n-2}.  The Bvh container, the refit, both record
packers and every traversal therefore consume the SAH trees with no change.

Form on this device
-------------------
The recursion runs LEVEL-SYNCHRONOUSLY: one host-loop iteration splits EVERY
current segment at once, on per-leaf-position state (my segment's
[first, last] and node id), with one device→host read of the loop condition
per level.  The JAX package phrases each level as segmented associative scans
with no gather or scatter; here a gather is cheap, so:

- prefix/suffix segment boxes are ONE global running maximum for both
  directions over int64 words ``(segment << 32) | ordered(value)`` — a later
  segment's words exceed every earlier one's, so the maximum restarts at each
  segment head, and the value is read back from the low 32 bits (``max`` is
  exact whatever the association, so the bits are the scans');
- each segment's best split is one ``scatter_reduce(amin)`` of the int64 key
  ``(ordered(cost) << 32) | position`` into the segment's first slot — the
  lexicographic (cost, position) minimum, i.e. the LEFTMOST minimum-cost
  candidate — gathered back to every position of the segment;
- ``sah_free`` re-sorts every segment's leaves along its largest
  centroid-extent axis with ONE stable ``torch.sort`` of
  ``(segment_first << 32) | ordered(centroid)`` per level.

Float order: the SAH cost is ``(ex*ey + ey*ez) + ez*ex`` per box and
``area_left*count_left + area_right*count_right``, each product and sum a
separate float32 operation in exactly this order (eager PyTorch fuses no
multiply-add), so the CPU, the card and a scalar float32 transcription of the
recursion agree bit for bit.

Segments still unsplit at ``max_sah_depth`` fall back to median splits,
bounding the loop at about ``max_sah_depth + log2(n)`` levels (every split
strictly shrinks both sides, so termination is structural).  The loop takes
one iteration per level of the tree, so ``Bvh.depth.max() + 1`` of a build
with ``diagnostics=True`` is the number of iterations it took.  Unique keys
are NOT required, so ``distribute_keys`` is unnecessary on these paths.
"""
from __future__ import annotations

import torch

from unitysimpleraytracing_tpu_torch.core.types import Bvh
from unitysimpleraytracing_tpu_torch.ops import lbvh
from unitysimpleraytracing_tpu_torch.utils.profiling import span

_LOW32 = 0xFFFFFFFF
_SIGN32 = 0x80000000


def _half_area(p: torch.Tensor) -> torch.Tensor:
    """Half surface area from a (6, cap) running box (-min rows, max rows)."""
    e = p[3:] + p[:3]
    return (e[0] * e[1] + e[1] * e[2]) + e[2] * e[0]


def _ordered_key(x: torch.Tensor) -> torch.Tensor:
    """Monotone float32 → int64 in [0, 2^32) (total order matching float <,
    with -0.0 below +0.0): flip all bits of negatives, set the sign bit of
    non-negatives."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & _LOW32
    return torch.where(u >= _SIGN32, ~u & _LOW32, u | _SIGN32)


def _key_to_float(packed: torch.Tensor) -> torch.Tensor:
    """The float32 whose `_ordered_key` sits in the low 32 bits of ``packed``."""
    low = packed & _LOW32
    bits = torch.where(low >= _SIGN32, low ^ _SIGN32, ~low & _LOW32)
    bits = torch.where(bits >= _SIGN32, bits - (1 << 32), bits)  # into int32's range
    return bits.to(torch.int32).view(torch.float32)


# A row is scanned in this many independent pieces: torch.cummax gives a row
# to one thread block, which walks a quarter of a million positions in
# hundreds of dependent steps; 64 pieces a row and one running maximum over
# the pieces' totals give the same values (max is associative and exact).
_SCAN_PIECES = 64


def _cummax_rows(packed: torch.Tensor) -> torch.Tensor:
    """Running maximum along dim 1 of a (k, cap) int64 tensor."""
    k, cap = packed.shape
    lowest = torch.iinfo(torch.int64).min
    # A capacity that is no multiple of the piece count (only tiny scenes) is
    # filled up at the end, where it changes no earlier maximum.
    packed = torch.nn.functional.pad(packed, (0, -cap % _SCAN_PIECES), value=lowest)
    within = torch.cummax(packed.reshape(k, _SCAN_PIECES, -1), dim=2).values
    totals = torch.cummax(within[:, :, -1], dim=1).values
    before = torch.nn.functional.pad(totals[:, :-1], (1, 0), value=lowest)
    return torch.maximum(within, before[:, :, None]).reshape(k, -1)[:, :cap]


def _seg_boxes(keys: torch.Tensor, f: torch.Tensor, l: torch.Tensor):
    """Segmented running max of the (6, cap) leaf boxes whose
    `_ordered_key` is ``keys``, in both directions at once: (P, S) with
    P[:, i] the box over [first, i] and S[:, i] the box over [i, last].

    One running maximum over int64 words ``(segment << 32) | key``: the
    segment number is constant on a segment and non-decreasing in scan
    direction (``first`` ascending; ``cap - 1 - last`` descending), so a later
    segment's words exceed every earlier one's and the maximum restarts at
    each segment head.  The value rides in the low 32 bits."""
    cap = f.shape[0]
    forward = (f[None, :] << 32) | keys
    backward = ((((cap - 1) - l)[None, :] << 32) | keys).flip(1)
    both = _key_to_float(_cummax_rows(torch.cat([forward, backward], dim=0)))
    k = keys.shape[0]
    return both[:k], both[k:].flip(1)


def _best_split(cost: torch.Tensor, ids: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Per position, its segment's leftmost minimum-cost index: the minimum
    of ``(cost, index)`` in lexicographic order over the segment."""
    c = cost.view(torch.int32)
    # Signed monotone image of float32: non-negative floats keep their bits,
    # negative ones reverse their order below zero.
    c = torch.where(c < 0, c ^ 0x7FFFFFFF, c).to(torch.int64)
    packed = (c << 32) | ids
    best = torch.full_like(packed, torch.iinfo(torch.int64).max)
    best.scatter_reduce_(0, f, packed, "amin", include_self=True)
    return best[f] & _LOW32


def _first_argmax3(x: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum over the 3 rows of a (3, cap) tensor."""
    a, b, c = x[0], x[1], x[2]
    return torch.where((a >= b) & (a >= c), 0, torch.where(b >= c, 1, 2))


def _sweep(keys, ids, f, l, act):
    """One level's SAH sweep over the current layout (the keys of the (6, cap)
    leaf boxes): (best split position per leaf position, prefix boxes P over
    [first, i], boxes S1 over [i+1, last])."""
    P, S = _seg_boxes(keys, f, l)
    S1 = torch.cat([S[:, 1:], S[:, -1:]], dim=1)
    cnt_l = (ids - f + 1).to(torch.float32)
    cnt_r = (l - ids).to(torch.float32)
    can = act & (ids < l)
    cost = torch.where(
        can, _half_area(P) * cnt_l + _half_area(S1) * cnt_r, float("inf")
    )
    return _best_split(cost, ids, f), P, S1


def _finish(o_f, o_l, o_s, o_ax, with_parents: bool):
    """The build_topology output tuple from the per-node (first, last, split,
    axis) arrays (int64 inside, int32 out)."""
    cap = o_s.shape[0]
    dev = o_s.device
    i32 = torch.int32
    valid = o_s >= 0  # exactly ids < n-1: the names cover {0..n-2}
    left = torch.where(valid, o_s, -1).to(i32)
    right = torch.where(valid, o_s + 1, -1).to(i32)
    left_is_leaf = valid & (o_s == o_f)
    right_is_leaf = valid & (o_s + 1 == o_l)
    if with_parents:
        internal_parent, leaf_parent = lbvh.parent_links(
            left, right, left_is_leaf, right_is_leaf, valid
        )
    else:
        internal_parent = torch.full((cap,), -1, dtype=i32, device=dev)
        leaf_parent = torch.full((cap,), -1, dtype=i32, device=dev)
    split_axis = torch.where(valid, o_ax, 0).to(i32)
    return (
        left, right, left_is_leaf, right_is_leaf,
        internal_parent, leaf_parent, o_f.to(i32), o_l.to(i32), split_axis,
    )


def _levels_left(act: torch.Tensor) -> bool:
    """The level loop's condition, whether any segment is still to split: one
    device→host read a level."""
    with span("readback.sah_level"):
        return bool(act.any())


def _initial_state(cap: int, n: int, dev):
    ids = torch.arange(cap, dtype=torch.int64, device=dev)
    in_scene = ids < n
    f = torch.where(in_scene, 0, ids)
    l = torch.where(in_scene, n - 1, ids)
    nid = torch.where(in_scene, 0, -1)
    act = in_scene & (n >= 2)
    neg1 = torch.full((cap,), -1, dtype=torch.int64, device=dev)
    return ids, f, l, nid, act, (neg1, neg1.clone(), neg1.clone(), torch.zeros_like(neg1))


def _emit_and_descend(ids, f, l, nid, act, best, axis, out):
    """Write each active segment's node and replace the segment by its two
    children: [f, best] named best (left), [best+1, l] named best+1."""
    o_f, o_l, o_s, o_ax = out
    # The segment's node id is one of its own endpoints, so the element AT
    # that index writes the node.
    emit = act & (ids == nid)
    out = (torch.where(emit, f, o_f), torch.where(emit, l, o_l),
           torch.where(emit, best, o_s), torch.where(emit, axis, o_ax))
    in_left = ids <= best
    l2 = torch.where(act & in_left, best, l)
    f2 = torch.where(act & ~in_left, best + 1, f)
    nid2 = torch.where(act, torch.where(in_left, best, best + 1), nid)
    return f2, l2, nid2, act & (f2 < l2), out


@torch.no_grad()
def build_topology_sah(
    sorted_tri: torch.Tensor,
    tri_aabb_min: torch.Tensor,
    tri_aabb_max: torch.Tensor,
    count: int,
    with_parents: bool = True,
    max_sah_depth: int = 40,
):
    """All internal nodes of the sweep-SAH tree over the sorted leaf order.

    Same output tuple as lbvh.build_topology: (left, right, left_is_leaf,
    right_is_leaf, internal_parent, leaf_parent, range_first, range_last,
    split_axis), each (capacity,), sentinel -1 on invalid rows.  The split
    axis is the largest component of (right-child centroid − left-child
    centroid) at the chosen split — an ordering hint for the traversals,
    never correctness.
    """
    cap = sorted_tri.shape[0]
    dev = sorted_tri.device
    n = int(count)
    # Sorted-leaf boxes as (-min, max) so both scan directions use max; one
    # row per component, leaf positions along the contiguous dimension.
    s = torch.cat([-tri_aabb_min, tri_aabb_max], dim=1)[sorted_tri.to(torch.int64)]
    keys = _ordered_key(s.t().contiguous())                          # (6, cap)
    ids, f, l, nid, act, out = _initial_state(cap, n, dev)

    level = 0
    while _levels_left(act):
        best, P, S1 = _sweep(keys, ids, f, l, act)
        if level >= max_sah_depth:  # median fallback bounds the loop
            best = (f + l) >> 1
        best = torch.minimum(torch.maximum(best, f), torch.maximum(l - 1, f))
        if level >= max_sah_depth:
            axis = torch.zeros_like(ids)
        else:
            # Right-child centroid − left-child centroid at every candidate,
            # read at the segment's chosen split.
            diff = 0.5 * (S1[3:] - S1[:3]) - 0.5 * (P[3:] - P[:3])
            axis = _first_argmax3(diff[:, best])
        f, l, nid, act, out = _emit_and_descend(ids, f, l, nid, act, best, axis, out)
        level += 1
    return _finish(*out, with_parents)


@torch.no_grad()
def build_topology_sah_free(
    init_order: torch.Tensor,
    tri_aabb_min: torch.Tensor,
    tri_aabb_max: torch.Tensor,
    count: int,
    with_parents: bool = True,
    max_sah_depth: int = 40,
):
    """FREE-ORDER sweep SAH: the builder REORDERS leaves instead of inheriting
    the Morton order.

    `build_topology_sah` can only choose split POSITIONS in the fixed sorted
    sequence; this builder additionally chooses each node's partition: per
    level every active segment picks its largest-extent centroid axis,
    re-sorts its own leaves along that axis, then runs the same full
    per-position SAH sweep — the classic top-down sweep SAH.

    The per-segment re-sort is ONE global stable sort on (segment_first,
    centroid_key) per level: segments are contiguous with globally ordered,
    per-segment-constant ``first``, so the sort permutes leaves only WITHIN
    segments.  Only the leaf permutation moves; all per-position segment
    state is constant within each segment and stays put.  Emitted node
    boundaries are never crossed by later sorts (children re-sort strictly
    inside their own half), so the recorded (first, last, split) ranges all
    refer to the FINAL permutation — which is returned and becomes
    ``Bvh.sorted_tri``.  The split axis is the partition axis.

    Returns the build_topology output tuple + the final leaf permutation.
    """
    cap = init_order.shape[0]
    dev = init_order.device
    n = int(count)
    # Global-order leaf data, gathered per level through the current perm.
    # One row per component, leaves along the contiguous dimension.
    skeys_g = _ordered_key(
        torch.cat([-tri_aabb_min, tri_aabb_max], dim=1).t().contiguous())    # (6, cap)
    cent_g = (0.5 * (tri_aabb_min + tri_aabb_max)).t().contiguous()         # (3, cap)
    ckey_g = _ordered_key(cent_g)
    c6_g = torch.cat([-cent_g, cent_g], dim=0)                              # (6, cap)
    ids, f, l, nid, act, out = _initial_state(cap, n, dev)
    perm = init_order.to(torch.int64)

    level = 0
    while _levels_left(act):
        # Segment centroid bounds → largest-extent axis per segment.
        C = torch.full((6, cap), float("-inf"), dtype=torch.float32, device=dev)
        C.scatter_reduce_(1, f[None, :].expand(6, -1), c6_g[:, perm], "amax",
                          include_self=True)
        C = C[:, f]
        axis = _first_argmax3(C[3:] + C[:3])

        # Re-sort every segment's leaves along its axis; perm is the only
        # moving payload.
        ckey = ckey_g[axis, perm]
        order = torch.sort((f << 32) | ckey, stable=True).indices
        perm = perm[order]

        best, _, _ = _sweep(skeys_g[:, perm], ids, f, l, act)
        if level >= max_sah_depth:  # median fallback bounds the loop
            best = (f + l) >> 1
        best = torch.minimum(torch.maximum(best, f), torch.maximum(l - 1, f))
        f, l, nid, act, out = _emit_and_descend(ids, f, l, nid, act, best, axis, out)
        level += 1
    return _finish(*out, with_parents), perm.to(torch.int32)


def _assemble(topology, sorted_tri, tri_aabb_min, tri_aabb_max, count: int,
              static_count: int | None, diagnostics: bool) -> Bvh:
    count = int(count)
    (
        left, right, left_is_leaf, right_is_leaf,
        internal_parent, leaf_parent, range_first, range_last, split_axis,
    ) = topology
    with span("build.assemble"):
        if diagnostics:
            depth = lbvh.compute_depths(internal_parent, count)
        else:
            depth = torch.full(
                (sorted_tri.shape[0],), -1, dtype=torch.int32, device=sorted_tri.device
            )
    with span("build.refit"):
        node_min, node_max = lbvh.refit(
            range_first, range_last, sorted_tri, tri_aabb_min, tri_aabb_max, count
        )
    return Bvh(
        left=left,
        right=right,
        left_is_leaf=left_is_leaf,
        right_is_leaf=right_is_leaf,
        internal_parent=internal_parent,
        leaf_parent=leaf_parent,
        range_first=range_first,
        range_last=range_last,
        split_axis=split_axis,
        node_aabb_min=node_min,
        node_aabb_max=node_max,
        sorted_tri=sorted_tri,
        depth=depth,
        count=count if static_count is None else int(static_count),
    )


@torch.no_grad()
def build_bvh_sah_free(
    init_order: torch.Tensor,
    tri_aabb_min: torch.Tensor,
    tri_aabb_max: torch.Tensor,
    count: int,
    static_count: int | None = None,
    diagnostics: bool = False,
    max_sah_depth: int = 40,
) -> Bvh:
    """Free-order sweep-SAH Bvh (``builder="sah_free"``): REORDERS the leaves
    and emits the permutation as ``sorted_tri``.  ``init_order`` seeds the
    permutation (any valid triangle-index order; the Morton-sorted order from
    the build pipeline is fine — the top levels re-sort it immediately).
    ``static_count``, as in the JAX package, is what the returned
    ``Bvh.count`` says (default: ``count``)."""
    with span("build.sah"):
        topology, sorted_tri = build_topology_sah_free(
            init_order, tri_aabb_min, tri_aabb_max, count,
            with_parents=diagnostics, max_sah_depth=max_sah_depth,
        )
    return _assemble(topology, sorted_tri, tri_aabb_min, tri_aabb_max, count,
                     static_count, diagnostics)


@torch.no_grad()
def build_bvh_sah_from_sorted(
    sorted_tri: torch.Tensor,
    tri_aabb_min: torch.Tensor,
    tri_aabb_max: torch.Tensor,
    count: int,
    static_count: int | None = None,
    diagnostics: bool = False,
    max_sah_depth: int = 40,
) -> Bvh:
    """Sweep-SAH Bvh from a Morton-sorted triangle order (the ``builder="sah"``
    analog of lbvh.build_bvh_from_sorted; no unique keys needed)."""
    with span("build.sah"):
        topology = build_topology_sah(
            sorted_tri, tri_aabb_min, tri_aabb_max, count,
            with_parents=diagnostics, max_sah_depth=max_sah_depth,
        )
    return _assemble(topology, sorted_tri, tri_aabb_min, tri_aabb_max, count,
                     static_count, diagnostics)

