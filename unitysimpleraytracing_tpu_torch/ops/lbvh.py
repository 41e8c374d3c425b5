"""Karras LBVH construction: topology + deterministic atomics-free AABB refit.

Topology produces EXACTLY the Karras 2012 binary radix tree of
``Assets/_Shaders/BVH/BVH.compute`` (``delta`` :23-33, ``DetermineRange``
:35-52, ``FindSplit`` :54-92, child/parent linking :111-148).  The searches
are carried over from the JAX package in their scan form, over the
adjacent-delta array ``adj[k] = delta(k, k+1)``, using two facts that hold for
the sorted distinct keys ``distribute_keys`` guarantees:

1. ``delta(x, y) = min(adj[x..y-1])`` (common prefix over a sorted range is
   the min of adjacent common prefixes), and adjacent deltas are never equal,
   so ``d = sign(delta(i,i+1) - delta(i,i-1))`` is always ±1 and:
   - d=+1: ``last  = min{k >= i  : adj[k] <= adj[i-1]}`` (sentinel n-1),
   - d=-1: ``first = max{k <  i  : adj[k] <= adj[i]} + 1`` (sentinel -1+1=0)
   — next/prev-smaller-or-equal queries.  ``adj`` values live in [-1, 31]
   (clz of a 31-bit nonzero xor; -1 = out-of-range sentinel,
   BVH.compute:29-32), so ALL 33 thresholds are answered at once by one
   reverse cummin / forward cummax over a (33, cap) masked-iota table and a
   per-node row select.
2. ``FindSplit``'s result is the LEFTMOST ARGMIN of ``adj`` over
   [first, last-1].  Every adj position k is the leftmost argmin of exactly
   one node's range (the Karras ranges are the Cartesian-tree ranges of adj),
   so the node→split map is inverted with two more row selects on the same
   tables and one scatter with unique targets.

Whether the per-node search form is faster on the card is an open question
(PERF.md); either form must give these arrays bit for bit.

The refit uses a structural fact of the Karras tree: internal node i covers
the CONTIGUOUS sorted-leaf range ``[first_i, last_i]``, so its AABB is exactly
the elementwise min/max of the leaf AABBs over that range — identical, bit for
bit, to the recursive merge of children (min/max are associative, commutative
and exact in f32).  A sparse table of power-of-2 windowed min/max answers
every node with two overlapping window lookups; no atomics, deterministic.
On the card the animated frame refits bottom-up instead, in one kernel
(ops/refit_bvh4.py), held to this refit bit for bit; the builds keep this one.
"""
from __future__ import annotations

import weakref

import torch

from unitysimpleraytracing_tpu_torch.core.types import Bvh
from unitysimpleraytracing_tpu_torch.utils.profiling import span

_INT32_MAX = 2**31 - 1
_NUM_ADJ = 33  # every value delta(k, k+1) can take: -1 .. 31


def _bit_length(x: torch.Tensor) -> torch.Tensor:
    """Number of bits of each non-negative element below 2^32 (0 for 0).

    torch has no count-leading-zeros op; a five-step binary search on shifts
    is exact on every device and needs no floating point."""
    x = x.clone()
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        hi = x >> s
        big = hi > 0
        n = n + big * s
        x = torch.where(big, hi, x)
    return n + (x > 0)


def _clz_xor(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Common-prefix length of two 32-bit codes held in int64
    (BVH.compute:18-21 clz32)."""
    return (32 - _bit_length(a ^ b)).to(torch.int32)


def _select_row(table: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """``table[value + 1, k]`` per column k, and 0 where ``value`` is outside
    [-1, 31] — the one-hot threshold select of the scan form as a gather."""
    row = (value + 1).to(torch.int64)
    ok = (row >= 0) & (row < _NUM_ADJ)
    got = torch.gather(table, 0, row.clamp(0, _NUM_ADJ - 1)[None, :])[0]
    return torch.where(ok, got, 0)


def build_topology(codes: torch.Tensor, count: int, with_parents: bool = True):
    """All internal-node ranges/splits at once (scan-form Karras — see module
    docstring; output is bit-identical to the reference searches, tested
    against the scalar transcription).

    Returns (left, right, left_is_leaf, right_is_leaf, internal_parent,
    leaf_parent, range_first, range_last, split_axis), each shaped
    (capacity,), int32/bool; invalid rows (i >= count-1) carry sentinel -1
    links.  ``range_first/last`` is node i's covered sorted-leaf interval
    (DetermineRange's [first, last], BVH.compute:35-52) — the refit consumes
    it as a range-min/max query span.
    """
    cap = codes.shape[0]
    dev = codes.device
    n = int(count)
    ids = torch.arange(cap, dtype=torch.int32, device=dev)

    # adj[k] = delta(k, k+1), with the reference's out-of-range sentinel -1
    # (BVH.compute:29-32) at every k >= n-1 — which also fences the range
    # walks at the array ends exactly like the reference's validity test.
    nxt_codes = torch.cat([codes[1:], codes[-1:]])
    adj = torch.where(ids <= n - 2, _clz_xor(codes, nxt_codes), -1)
    adj_prev = torch.cat([adj.new_full((1,), -1), adj[:-1]])

    # d = sign(delta(i,i+1) - delta(i,i-1)); never 0 for distinct keys.
    d_pos = adj > adj_prev
    dmin = torch.where(d_pos, adj_prev, adj)

    # next/prev-smaller-or-equal for all 33 thresholds at once, with the
    # boundary's adj VALUE riding in the low 6 bits of the packed word
    # (position-major: (pos << 6) | (adj+2), adj+2 ∈ [1, 33]):
    #   nxt[v, i] packs min{k >= i : adj[k] <= v}   (sentinel INT_MAX)
    #   prv[v, i] packs max{k <  i : adj[k] <= v}   (sentinel -1)
    vals = torch.arange(-1, 32, dtype=torch.int32, device=dev)[:, None]  # (33, 1)
    leq = adj[None, :] <= vals                                            # (33, cap)
    packed_pv = ((ids << 6) | (adj + 2))[None, :]
    nxt = torch.where(leq, packed_pv, _INT32_MAX)
    nxt = torch.cummin(nxt.flip(1), dim=1).values.flip(1)
    prv_inc = torch.cummax(torch.where(leq, packed_pv, -1), dim=1).values
    del leq
    prv = torch.cat([prv_inc.new_full((_NUM_ADJ, 1), -1), prv_inc[:, :-1]], dim=1)
    del prv_inc

    # Each node's threshold row (dmin ∈ [-1, 31]); positions are the packed
    # words' high bits (sentinels -1 and INT_MAX shift to -1 and a large
    # positive).
    last_sel = _select_row(nxt, dmin) >> 6
    first_sel = (_select_row(prv, dmin) >> 6) + 1
    first = torch.where(d_pos, ids, first_sel)
    last = torch.where(d_pos, last_sel, ids)

    # Split per node by inverting the node→split map:
    #   f_k = prv[adj[k]][k] + 1          (ties on the left excluded —
    #                                      leftmost-argmin convention)
    #   l_k = pos of nxt[adj[k]-1][k+1]   (strictly-smaller boundary; ties
    #                                      on the right are inside)
    #   name = f_k iff the LEFT boundary delta exceeds the right one (the
    #   parent's split sits at the larger boundary delta; out-of-range
    #   boundaries are -inf, the root special-cases to 0), else l_k.
    a = adj
    pk_prv = _select_row(prv, a)
    f_pos = (pk_prv >> 6) + 1
    f_val = (pk_prv & 63) - 2                                   # adj at f_k-1
    nxt_excl = torch.cat(
        [nxt[:, 1:], nxt.new_full((_NUM_ADJ, 1), _INT32_MAX)], dim=1
    )
    pk_nxt = _select_row(nxt_excl, a - 1)
    del nxt, prv, nxt_excl
    l_pos = torch.clamp(pk_nxt >> 6, max=n - 1)
    NEG = -100
    adj_left = torch.where(f_pos > 0, f_val, NEG)
    adj_right = torch.where(l_pos < n - 1, (pk_nxt & 63) - 2, NEG)
    name = torch.where(adj_left > adj_right, f_pos, l_pos)
    name = torch.where((f_pos == 0) & (l_pos == n - 1), 0, name)
    # Scatter with unique in-range targets: every valid k names a different
    # node.
    with span("readback.topology_split"):
        valid_k = (ids <= n - 2).nonzero(as_tuple=True)[0]
    rmq = torch.zeros(cap, dtype=torch.int32, device=dev)
    rmq[name[valid_k].to(torch.int64)] = (((a + 1) << 25) | ids)[valid_k]
    split = rmq & ((1 << 25) - 1)

    # Traversal ordering hint: the split separates codes at bit
    # (31 - adj[split]); with the x-major interleave ``xx*4 + yy*2 + zz``
    # (core/morton.py) bit b belongs to axis 2 - b % 3 ∈ {0:x, 1:y, 2:z}.
    # The left child covers the LOWER half along that axis, so "near child" =
    # left iff the ray direction's component on that axis is positive.
    # Heuristic only: affects traversal order, never the hit set.
    adj_split = (rmq >> 25) - 1
    bit_pos = torch.clamp(31 - adj_split, min=0)
    split_axis = 2 - (bit_pos % 3)

    valid = ids < n - 1
    left = torch.where(valid, split, -1)
    right = torch.where(valid, split + 1, -1)
    left_is_leaf = valid & (split == first)
    right_is_leaf = valid & (split + 1 == last)

    # The Bvh's own parent links are diagnostic-only: the render path reads
    # the links `topology_links` makes once per topology.
    if with_parents:
        internal_parent, leaf_parent = parent_links(
            left, right, left_is_leaf, right_is_leaf, valid
        )
    else:
        internal_parent = torch.full((cap,), -1, dtype=torch.int32, device=dev)
        leaf_parent = torch.full((cap,), -1, dtype=torch.int32, device=dev)

    range_first = torch.where(valid, first, -1)
    range_last = torch.where(valid, last, -1)
    split_axis = torch.where(valid, split_axis, 0)
    return (
        left, right, left_is_leaf, right_is_leaf,
        internal_parent, leaf_parent, range_first, range_last, split_axis,
    )


def _scatter_ids(target: torch.Tensor, index: torch.Tensor, mask: torch.Tensor):
    """target[index[i]] = i where mask[i] (unique in-range indices), in place."""
    with span("readback.parent_links"):
        sel = mask.nonzero(as_tuple=True)[0]
    target[index[sel].to(torch.int64)] = sel.to(target.dtype)


def parent_links(left, right, left_is_leaf, right_is_leaf, valid):
    """Parent arrays from child links via 4 masked scatters.  Works for ANY
    contiguous-range binary tree."""
    cap = left.shape[0]
    internal_parent = torch.full((cap,), -1, dtype=torch.int32, device=left.device)
    leaf_parent = torch.full((cap,), -1, dtype=torch.int32, device=left.device)
    _scatter_ids(internal_parent, left, valid & ~left_is_leaf)
    _scatter_ids(internal_parent, right, valid & ~right_is_leaf)
    _scatter_ids(leaf_parent, left, valid & left_is_leaf)
    _scatter_ids(leaf_parent, right, valid & right_is_leaf)
    return internal_parent, leaf_parent


# id(bvh.left) -> (weakref(left), internal_parent, leaf_parent).  Keyed by
# the topology tensor's identity: a refitted tree keeps ``left``, so it finds
# the links of the tree it was refitted from.
_LINKS_CACHE: dict = {}


def topology_links(bvh: Bvh):
    """(internal_parent, leaf_parent) of the tree's topology, made once per
    topology by `parent_links` (its four read-backs) and cached.  The BVH4
    record mask and the refit kernel (ops/refit_bvh4.py) read them; a
    non-diagnostic build leaves the Bvh's own fields -1-filled."""
    key = id(bvh.left)
    ent = _LINKS_CACHE.get(key)
    if ent is not None and ent[0]() is bvh.left:
        return ent[1], ent[2]
    cap = bvh.left.shape[0]
    valid = torch.arange(cap, dtype=torch.int32, device=bvh.left.device) < bvh.count - 1
    links = parent_links(bvh.left, bvh.right, bvh.left_is_leaf, bvh.right_is_leaf, valid)
    ref = weakref.ref(bvh.left, lambda _r, _k=key: _LINKS_CACHE.pop(_k, None))
    _LINKS_CACHE[key] = (ref, *links)
    return links


def _chains_left(jump: torch.Tensor) -> bool:
    """The pointer chase's loop condition: one device→host read."""
    with span("readback.depths"):
        return bool(torch.any(jump >= 0))


def compute_depths(internal_parent: torch.Tensor, count: int) -> torch.Tensor:
    """Depth of every internal node from the root (node 0) by POINTER DOUBLING.

    Invariant: when ``jump[i] == -1``, ``dist[i] == depth(i)``; when
    ``jump[i] == j >= 0``, ``dist[i] == depth(i) - depth(j)``.  Each pass
    composes every chain with itself (``jump' = jump[jump]``), so the chase
    converges in ceil(log2(max_depth)) + 1 passes of two gathers.  Each pass
    ends with one device→host read of the loop condition.
    """
    cap = internal_parent.shape[0]
    ids = torch.arange(cap, dtype=torch.int32, device=internal_parent.device)
    valid = ids < count - 1
    jump = torch.where(valid, internal_parent, -1)
    dist = (jump >= 0).to(torch.int32)
    while _chains_left(jump):
        alive = jump >= 0
        j = jump.clamp(0, cap - 1).to(torch.int64)
        dist = torch.where(alive, dist + dist[j], dist)
        jump = torch.where(alive, jump[j], -1)
    return torch.where(valid, dist, -1)


def refit(
    range_first,
    range_last,
    sorted_tri,
    tri_aabb_min,
    tri_aabb_max,
    count: int,
):
    """Range-query AABB refit (deterministic replacement for
    BVH.compute:172-220).

    Node i's AABB == elementwise min/max of the sorted-leaf AABBs over its
    contiguous covered range [first_i, last_i], with leaf boxes resolved via
    ``tri_aabb[sorted_tri[leaf]]`` exactly like BVH.compute:203,212.  A sparse
    table of power-of-2 windowed min/max is built in log2(cap) shift+max
    passes, then every node reads two overlapping windows:
    ``[first, first+2^k) ∪ [last-2^k+1, last+1)`` with k = floor(log2(len)).
    """
    cap = range_first.shape[0]
    dev = range_first.device
    ids = torch.arange(cap, dtype=torch.int32, device=dev)
    valid = ids < count - 1

    # Sorted-leaf AABB sequence, min NEGATED so both halves combine with a
    # single elementwise max and one 6-wide gather per lookup.
    s = torch.cat([-tri_aabb_min, tri_aabb_max], dim=1)[sorted_tri.to(torch.int64)]

    levels = max(int(cap).bit_length(), 1)  # window sizes 2^0 .. 2^(levels-1)
    table = torch.empty((levels, cap, 6), dtype=s.dtype, device=dev)
    table[0] = s
    w = 1
    for lvl in range(1, levels):
        p = table[lvl - 1]
        # Rows past cap-w read -inf pads; valid queries never touch them
        # (their window always fits inside [0, count)).  Written in place
        # into the preallocated level to save a concatenation of the table.
        table[lvl, : cap - w] = torch.maximum(p[: cap - w], p[w:])
        table[lvl, cap - w:] = p[cap - w:]
        w *= 2
    table = table.reshape(levels * cap, 6)

    first = range_first.clamp(0, cap - 1).to(torch.int64)
    last = range_last.clamp(0, cap - 1).to(torch.int64)
    length = torch.clamp(last - first + 1, min=1)
    k = _bit_length(length) - 1  # floor(log2(length))
    second = last + 1 - (torch.ones_like(k) << k)
    merged = torch.maximum(table[k * cap + first], table[k * cap + second])
    node_min = torch.where(valid[:, None], -merged[:, 0:3], 0.0)
    node_max = torch.where(valid[:, None], merged[:, 3:6], 0.0)
    return node_min, node_max


def build_bvh_from_sorted(
    codes: torch.Tensor,
    sorted_tri: torch.Tensor,
    tri_aabb_min: torch.Tensor,
    tri_aabb_max: torch.Tensor,
    count: int,
    diagnostics: bool = False,
) -> Bvh:
    """Full LBVH from uniquified sorted codes (the reference's
    ConstructTree + ConstructBVH sequence, BVHConstructor.cs:61-69).

    ``diagnostics=False`` (default) skips the parent-link scatters and the
    per-node depth array — validation-only data nothing in the render path
    reads; -1 filled.  Pass True — or use :func:`attach_diagnostics` later —
    where validation wants them."""
    with span("build.topology"):
        (
            left,
            right,
            left_is_leaf,
            right_is_leaf,
            internal_parent,
            leaf_parent,
            range_first,
            range_last,
            split_axis,
        ) = build_topology(codes, count, with_parents=diagnostics)
        if diagnostics:
            depth = compute_depths(internal_parent, count)
        else:
            depth = torch.full(
                (codes.shape[0],), -1, dtype=torch.int32, device=codes.device
            )
    with span("build.refit"):
        node_min, node_max = refit(
            range_first,
            range_last,
            sorted_tri,
            tri_aabb_min,
            tri_aabb_max,
            count,
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
        count=count,
    )


def attach_diagnostics(bvh: Bvh) -> Bvh:
    """Fill the diagnostic parent links + depth array of a Bvh built without
    them (recomputed from the child links; identical to a diagnostics=True
    build)."""
    cap = bvh.left.shape[0]
    ids = torch.arange(cap, dtype=torch.int32, device=bvh.left.device)
    valid = ids < bvh.count - 1
    internal_parent, leaf_parent = parent_links(
        bvh.left, bvh.right, bvh.left_is_leaf, bvh.right_is_leaf, valid
    )
    return bvh.replace(
        internal_parent=internal_parent,
        leaf_parent=leaf_parent,
        depth=compute_depths(internal_parent, bvh.count),
    )
