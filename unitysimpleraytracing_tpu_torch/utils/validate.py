"""Pipeline validators, promoted from the reference's inline runtime checks.

Counterpart of ``unitysimpleraytracing_tpu/utils/validate.py``.  The
reference has no test framework; instead it re-derives expected results on
the CPU after every GPU pass: sortedness + duplicate census
(``ComputeBufferSorter.cs:150-177``), per-digit histogram permutation checks
(:193-224), per-block histogram equality (:226-254), prefix-sum recurrence
(:256-271), and null-sentinel corruption scans
(``MeshBufferContainer.cs:181-195``).  Here those mechanisms are first-class
library functions the test suite (and users) call on demand.

All functions take tensors (brought to the host explicitly) or anything
``np.asarray`` accepts, and raise AssertionError with a diagnostic on
failure.  The per-node checks are numpy vector code, so they stay usable at
hundreds of thousands of nodes.
"""
from __future__ import annotations

import numpy as np
import torch

from unitysimpleraytracing_tpu_torch import constants as C
from unitysimpleraytracing_tpu_torch.core.types import Bvh
from unitysimpleraytracing_tpu_torch.utils.device import resolve_device


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _digits(keys, shift: int) -> np.ndarray:
    k = _np(keys).astype(np.uint64)
    return ((k >> np.uint64(shift)) & np.uint64(C.NUM_BUCKETS - 1)).astype(np.int64)


def check_sorted(keys, count: int) -> None:
    """Ascending order over the logical prefix (ComputeBufferSorter.cs:150-162)."""
    k = _np(keys)[:count]
    bad = np.nonzero(k[1:] < k[:-1])[0]
    assert bad.size == 0, f"sort order violated at indices {bad[:10]}"


def check_permutation(keys_in, keys_out, count: int) -> None:
    """Output is a permutation of input: full multiset equality (stronger than
    the reference's 256-bucket histogram diff, ComputeBufferSorter.cs:193-224)."""
    a = np.sort(_np(keys_in)[:count])
    b = np.sort(_np(keys_out)[:count])
    assert np.array_equal(a, b), "sort output is not a permutation of its input"


def check_stability(keys_in, values_in, keys_out, values_out, count: int) -> None:
    """Stable ties: equal keys keep their original value order."""
    ki = _np(keys_in)[:count]
    vi = _np(values_in)[:count]
    ko = _np(keys_out)[:count]
    vo = _np(values_out)[:count]
    order = np.argsort(ki, kind="stable")
    assert np.array_equal(ko, ki[order]), "keys mismatch vs stable oracle"
    assert np.array_equal(vo, vi[order]), "values violate stability"


def check_scan_recurrence(raw, scanned) -> None:
    """Exclusive-scan recurrence scanned[i] == raw[i-1] + scanned[i-1]
    (ComputeBufferSorter.cs:256-271)."""
    raw = _np(raw).astype(np.int64)
    s = _np(scanned).astype(np.int64)
    assert s[0] == 0, f"scan[0] = {s[0]} != 0"
    expect = np.cumsum(raw)[:-1]
    bad = np.nonzero(s[1:] != expect)[0]
    assert bad.size == 0, f"scan recurrence violated at {bad[:10] + 1}"


def check_digit_histogram(keys_in, keys_out, shift: int) -> None:
    """Per-pass permutation check via 256-bucket histogram diff of the pass's
    digit — exactly the reference's in-situ check
    (ComputeBufferSorter.cs:193-224)."""
    hin = np.bincount(_digits(keys_in, shift), minlength=C.NUM_BUCKETS)
    hout = np.bincount(_digits(keys_out, shift), minlength=C.NUM_BUCKETS)
    bad = np.nonzero(hin != hout)[0]
    assert bad.size == 0, (
        f"digit-pass histogram diff at buckets {bad[:10]} (shift {shift})"
    )


def check_block_histograms(keys_in, hist_t, shift: int, block: int) -> None:
    """The engine's own per-block histogram (the transposed ``sizesData``
    layout, LocalRadixSort.compute:132) equals a host recount — the
    reference's per-block check (ComputeBufferSorter.cs:226-254)."""
    d = _digits(keys_in, shift)
    n = d.shape[0]
    assert n % block == 0
    nblocks = n // block
    cell = np.repeat(np.arange(nblocks), block) * C.NUM_BUCKETS + d
    want = np.bincount(cell, minlength=nblocks * C.NUM_BUCKETS).reshape(
        nblocks, C.NUM_BUCKETS
    )
    got = _np(hist_t).astype(np.int64).reshape(C.NUM_BUCKETS, nblocks).T
    assert np.array_equal(got, want), "per-block histogram mismatch vs host recount"


def check_pass_stable(keys_in, values_in, keys_out, values_out, shift: int) -> None:
    """One digit pass's full contract: output = stable sort of input by this
    pass's digit alone (the invariant every LSD pass must preserve)."""
    ki = _np(keys_in)
    order = np.argsort(_digits(ki, shift), kind="stable")
    assert np.array_equal(_np(keys_out), ki[order]), (
        f"pass (shift {shift}) keys != stable digit sort"
    )
    assert np.array_equal(_np(values_out), _np(values_in)[order]), (
        f"pass (shift {shift}) values violate stability"
    )


def validate_sort_pass(
    keys_in, values_in, keys_out, values_out, hist_t, scanned,
    shift: int, block: int,
) -> None:
    """All of the reference's per-digit-pass in-situ checks on one pass's
    observables (ComputeBufferSorter.cs:107-125 runs these after every GPU
    pass): scan recurrence, per-block histogram recount, digit histogram
    permutation, and the stable-digit-sort contract."""
    check_scan_recurrence(hist_t, scanned)
    check_block_histograms(keys_in, hist_t, shift, block)
    check_digit_histogram(keys_in, keys_out, shift)
    check_pass_stable(keys_in, values_in, keys_out, values_out, shift)


def validate_sort_per_pass(keys, values, impl: str = "radix", device=None) -> None:
    """Drive every digit pass of the decomposed sort engines standalone and
    validate each pass's intermediates — the per-pass parity of the
    reference's ``Sort()`` loop (ComputeBufferSorter.cs:102-125).

    ``impl``: "radix" (the pass decomposition in plain tensor code) or "cuda"
    (the kernel path; its wrappers run their plain versions on CPU tensors).
    The "torch" engine is one fused sort with no per-pass observables — its
    end-to-end output is checked by check_sorted/check_permutation/
    check_stability instead.  Tensors are sorted where they lie; other
    array-likes are first put on ``device`` (None = the card; uint32 keys
    become the port's int64)."""
    from unitysimpleraytracing_tpu_torch.ops import sort as sort_ops

    if not isinstance(keys, torch.Tensor):
        keys = torch.from_numpy(_np(keys).astype(np.int64)).to(resolve_device(device))
    if not isinstance(values, torch.Tensor):
        values = torch.from_numpy(np.ascontiguousarray(_np(values))).to(keys.device)
    n = keys.shape[0]
    if impl == "cuda":
        from unitysimpleraytracing_tpu_torch.ops import sort_radix_cuda

        block = sort_radix_cuda.BLOCK
        pass_fn = sort_radix_cuda.cuda_pass_debug
    else:
        assert impl == "radix", impl
        block = min(C.SORT_BLOCK, n)
        pass_fn = sort_ops.radix_pass_debug
    # Pad to a block multiple with tail-sorting max keys — capacity-padded
    # scene arrays are not generally block multiples.
    keys, values = sort_ops.pad_to_block(keys.contiguous(), values, block)
    for p in range(C.NUM_PASSES):
        shift = p * C.RADIX_BITS
        keys_out, values_out, hist_t, scanned = pass_fn(keys, values, shift)
        validate_sort_pass(
            keys, values, keys_out, values_out, hist_t, scanned, shift, block
        )
        keys, values = keys_out, values_out
    check_sorted(keys, keys.shape[0])


def check_unique_strictly_increasing(keys, count: int) -> None:
    """distribute_keys postcondition (BVH.compute:29's precondition)."""
    k = _np(keys)[:count].astype(np.int64)
    assert k[0] == 0, f"first key {k[0]} != 0"
    d = np.diff(k)
    bad = np.nonzero(d < 1)[0]
    assert bad.size == 0, f"keys not strictly increasing at {bad[:10]}"


def _links(bvh: Bvh):
    n = bvh.count
    return (
        _np(bvh.left)[: n - 1], _np(bvh.right)[: n - 1],
        _np(bvh.left_is_leaf)[: n - 1], _np(bvh.right_is_leaf)[: n - 1],
        _np(bvh.internal_parent)[: n - 1],
    )


def check_topology(bvh: Bvh) -> None:
    """Structural invariants of the Karras tree.

    - every node (except root) has exactly one parent, matching child links
    - the n leaves and n-1 internal nodes are each referenced exactly once
    - no null-sentinel links among valid nodes (the reference's "CORRUPTED"
      scan, MeshBufferContainer.cs:181-195)
    """
    n = bvh.count
    left, right, lleaf, rleaf, iparent = _links(bvh)
    lparent = _np(bvh.leaf_parent)[:n]

    assert np.all(left >= 0) and np.all(right >= 0), "null child link"
    assert np.all(lparent >= 0), "leaf with no parent (LEAF CORRUPTED)"
    if n > 1:
        assert iparent[0] == C.NULL_INDEX, "root must have sentinel parent"
        assert np.all(iparent[1:] >= 0), "internal node with no parent"

    leaf_refs = np.zeros(n, np.int64)
    internal_refs = np.zeros(n - 1, np.int64)
    for child, is_leaf in ((left, lleaf), (right, rleaf)):
        np.add.at(leaf_refs, child[is_leaf], 1)
        np.add.at(internal_refs, child[~is_leaf], 1)
    assert np.all(leaf_refs == 1), f"leaf reference counts wrong: {np.nonzero(leaf_refs != 1)[0][:10]}"
    expected = np.ones(n - 1, np.int64)
    expected[0] = 0  # root is nobody's child
    assert np.array_equal(internal_refs, expected), "internal reference counts wrong"

    # Parent links agree with child links; the first offender in node order
    # (left before right) is named.
    ids = np.arange(n - 1)
    bad = []
    for child, is_leaf in ((left, lleaf), (right, rleaf)):
        parent_of_child = np.empty(n - 1, np.int64)
        parent_of_child[is_leaf] = lparent[child[is_leaf]]
        parent_of_child[~is_leaf] = iparent[child[~is_leaf]]
        bad.append(parent_of_child != ids)
    if bad[0].any() or bad[1].any():
        i = int(np.nonzero(bad[0] | bad[1])[0][0])
        child, is_leaf = (left, lleaf) if bad[0][i] else (right, rleaf)
        kind = "leaf" if is_leaf[i] else "internal"
        raise AssertionError(f"{kind} {child[i]} parent mismatch")


def _depths_from_parents(iparent: np.ndarray) -> np.ndarray:
    """Depth of every internal node, chasing all parent chains together (a
    radix tree over 32-bit keys is a few dozen levels deep)."""
    depth = np.zeros(iparent.shape[0], np.int64)
    p = iparent.astype(np.int64)
    for _ in range(iparent.shape[0]):
        live = np.nonzero(p >= 0)[0]
        if live.size == 0:
            return depth
        depth[live] += 1
        p[live] = iparent[p[live]]
    raise AssertionError("parent links form a cycle")


def check_refit(bvh: Bvh, tri_aabb_min, tri_aabb_max) -> None:
    """Every internal AABB equals the exact merge of its children — the
    recursive recomputation the reference's atomic refit promises
    (BVH.compute:191-215). Verified bottom-up on the host, bit-exact."""
    n = bvh.count
    left, right, lleaf, rleaf, iparent = _links(bvh)
    # Level order derived from parent links on the host (independent of the
    # optional bvh.depth diagnostic array; parents may have HIGHER ids than
    # children in a Karras tree).
    depth = _depths_from_parents(iparent)
    sorted_tri = _np(bvh.sorted_tri)
    node_min = _np(bvh.node_aabb_min)[: n - 1]
    node_max = _np(bvh.node_aabb_max)[: n - 1]
    tmin = _np(tri_aabb_min)
    tmax = _np(tri_aabb_max)

    exp_min = np.zeros_like(node_min)
    exp_max = np.zeros_like(node_max)

    def child_boxes(ids, child, is_leaf):
        c, leaf = child[ids], is_leaf[ids]
        lo, hi = np.empty((ids.size, 3), tmin.dtype), np.empty((ids.size, 3), tmax.dtype)
        lo[leaf], hi[leaf] = tmin[sorted_tri[c[leaf]]], tmax[sorted_tri[c[leaf]]]
        lo[~leaf], hi[~leaf] = exp_min[c[~leaf]], exp_max[c[~leaf]]
        return lo, hi

    for level in range(int(depth.max()), -1, -1):
        ids = np.nonzero(depth == level)[0]
        lmin, lmax = child_boxes(ids, left, lleaf)
        rmin, rmax = child_boxes(ids, right, rleaf)
        exp_min[ids] = np.minimum(lmin, rmin)
        exp_max[ids] = np.maximum(lmax, rmax)
    assert np.array_equal(node_min, exp_min), "refit min mismatch"
    assert np.array_equal(node_max, exp_max), "refit max mismatch"


def check_depths(bvh: Bvh) -> None:
    """Depth array consistency: root 0, child = parent + 1."""
    n = bvh.count
    depth = _np(bvh.depth)[: n - 1]
    iparent = _np(bvh.internal_parent)[: n - 1]
    assert depth[0] == 0
    bad = np.nonzero(depth[1:] != depth[iparent[1:]] + 1)[0]
    assert bad.size == 0, f"depth broken at {bad[0] + 1}"
