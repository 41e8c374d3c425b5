"""End-to-end BVH build: sort → uniquify → topology → refit.

The reference performs this once in ``Awake`` as a sequence of host-driven
GPU dispatches with CPU round-trips between stages
(``RaytracingMeshDrawer.cs:30-55``).  Here the stages are eager tensor code on
the scene's device and nothing returns to the host.  The sort carries the
triangle indices exactly like the reference's (key, value) pair sort;
``distribute_keys`` then replaces the reference's GPU→CPU→GPU uniquification
round-trip (MeshBufferContainer.cs:154-169).
"""
from __future__ import annotations

import torch

from unitysimpleraytracing_tpu_torch import constants as C
from unitysimpleraytracing_tpu_torch.core.types import Bvh, Scene
from unitysimpleraytracing_tpu_torch.ops import lbvh, refit_bvh4, sah, sort, unique
from unitysimpleraytracing_tpu_torch.utils.profiling import span

BUILDERS = ("karras", "sah", "sah_free")


def _build(scene: Scene, sort_impl: str, diagnostics: bool, builder: str) -> Bvh:
    with span("build.sort"):
        keys, sorted_tri = sort.sort_key_val(scene.morton, scene.tri_index, impl=sort_impl)
    if builder == "sah":
        # Sweep SAH over the Morton order (ops/sah.py): better splits, same
        # hit contract; needs no unique keys, so distribute_keys is skipped.
        return sah.build_bvh_sah_from_sorted(
            sorted_tri, scene.aabb_min, scene.aabb_max, scene.count,
            diagnostics=diagnostics,
        )
    if builder == "sah_free":
        # Free-order sweep SAH (ops/sah.py): additionally re-partitions the
        # leaves per node (one stable sort per level); the emitted
        # permutation replaces the Morton order as sorted_tri.
        return sah.build_bvh_sah_free(
            sorted_tri, scene.aabb_min, scene.aabb_max, scene.count,
            diagnostics=diagnostics,
        )
    with span("build.unique"):
        keys = unique.distribute_keys(keys, scene.count)
    return lbvh.build_bvh_from_sorted(
        keys, sorted_tri, scene.aabb_min, scene.aabb_max, scene.count,
        diagnostics=diagnostics,
    )


@torch.no_grad()
def build_bvh(
    scene: Scene,
    sort_impl: str = "torch",
    diagnostics: bool = False,
    validate: bool = False,
    builder: str | None = None,
) -> Bvh:
    """Construct the BVH for a scene. Requires scene.count >= 2.

    ``sort_impl``: the key sort's engine (`ops/sort.sort_key_val`): "torch"
    (one stable ``torch.sort``, the default), "radix" (the reference's
    four-pass decomposition in plain tensor code) or "cuda" (the same
    decomposition on the hand-written histogram, scan and rank kernels).  All
    three are stable, so the tree is the same bit for bit.

    ``builder``: "karras" (the reference's radix tree, BVH.compute:94-149,
    the bit-parity surface), "sah" (sweep SAH over the Morton order,
    ops/sah.py — lower SAH cost, same hit contract) or "sah_free" (free-order
    sweep SAH — re-partitions the leaves per node, lowest SAH cost).  The
    default ``None`` resolves to "sah_free": that is the JAX package's rule
    for concrete builds, and PyTorch has no traced case.  The SAH builds are
    host loops of one level per iteration and cost far more than the Karras
    build (PERF.md); a loop that rebuilds every frame asks for "karras".

    ``diagnostics`` adds the parent links + per-node depth array
    (validation only; nothing in the render path reads them).

    ``validate=True`` runs the promoted runtime validators in situ on the
    user's actual scene — the reference validates every sort pass inside the
    real pipeline the same way (ComputeBufferSorter.cs:107-125, readback +
    permutation/order checks; MeshBufferContainer.cs:181-195 corruption
    scan).  Host-side readbacks: debug-grade cost, raises AssertionError on
    the first violated invariant.
    """
    if scene.count < 2:
        raise ValueError("LBVH needs at least 2 triangles (reference assumes the same)")
    if builder is None:
        builder = "sah_free"
    if builder not in BUILDERS:
        raise ValueError(f"unknown builder {builder!r}; one of {BUILDERS}")
    if not validate:
        return _build(scene, sort_impl, diagnostics, builder)

    from unitysimpleraytracing_tpu_torch.utils import validate as V

    count = scene.count
    bvh = _build(scene, sort_impl, diagnostics=True, builder=builder)
    # Sort pass (re-run standalone so pre/post states are observable).
    keys_sorted, tri_sorted = sort.sort_key_val(
        scene.morton, scene.tri_index, impl=sort_impl
    )
    V.check_sorted(keys_sorted, count)
    V.check_permutation(scene.morton, keys_sorted, count)
    V.check_stability(scene.morton, scene.tri_index, keys_sorted, tri_sorted, count)
    # DistributeKeys postcondition (BVH.compute:29's precondition).
    V.check_unique_strictly_increasing(
        unique.distribute_keys(keys_sorted, count), count
    )
    # Per-digit-pass validation of the decomposed engines — the reference
    # validates after EVERY pass inside the running pipeline
    # (ComputeBufferSorter.cs:107-125): scan recurrence, per-block histogram
    # recount, digit-histogram permutation, stable-digit contract.  The
    # "torch" engine is one fused sort with no pass observables; the radix
    # decomposition is validated on the scene's actual keys, and the kernel
    # path too: on all of them on the card, capped on the CPU, where its
    # wrappers run their plain versions.
    V.validate_sort_per_pass(scene.morton, scene.tri_index, impl="radix")
    n_cuda = count if scene.morton.device.type == "cuda" else min(count, 16384)
    V.validate_sort_per_pass(
        scene.morton[:n_cuda], scene.tri_index[:n_cuda], impl="cuda"
    )
    # Tree topology + refit coverage (the "CORRUPTED" scans).
    V.check_topology(bvh)
    V.check_depths(bvh)
    V.check_refit(bvh, scene.aabb_min, scene.aabb_max)
    # The validated build carries the diagnostic links either way (a
    # superset of the diagnostics=False result; nothing downstream reads
    # them) — no second build.
    return bvh


@torch.no_grad()
def deform_scene(scene: Scene, positions: torch.Tensor) -> Scene:
    """Replace vertex positions (T, 3, 3), keeping topology-related fields.

    For per-frame vertex animation: per-triangle AABBs are recomputed (the
    refit inputs), while Morton codes and the sorted order are intentionally
    left stale — `refit_bvh` stays correct under any deformation (every node
    box still bounds its subtree), the tree merely loses quality as geometry
    drifts from its original Morton order; re-run `build_bvh` to re-optimize.
    """
    a, b, c = positions[:, 0], positions[:, 1], positions[:, 2]
    amin = torch.minimum(torch.minimum(a, b), c) - C.AABB_INFLATION
    amax = torch.maximum(torch.maximum(a, b), c) + C.AABB_INFLATION
    tris = scene.triangles.replace(
        a=a.contiguous(), b=b.contiguous(), c=c.contiguous()
    )
    return scene.replace(triangles=tris, aabb_min=amin, aabb_max=amax)


@torch.no_grad()
def refit_bvh(scene: Scene, bvh: Bvh) -> Bvh:
    """Refit node AABBs to the scene's current triangle AABBs, keeping the
    tree topology (the fast path for deforming meshes — the reference has no
    equivalent: it rebuilds everything each Awake).

    Exact: output equals a fresh refit of the same topology over the new leaf
    boxes (``lbvh.refit``), bit for bit.  On the card this is one launch of
    the bottom-up refit kernel (`refit_bvh4.refit_nodes`), which climbs the
    parent links `lbvh.topology_links` makes once per topology; on the CPU,
    ``lbvh.refit`` itself.  ``replace`` keeps the topology tensors' object
    identity, which the per-topology caches key on — a refit-per-frame render
    loop skips the parent links and the depth chase when repacking
    (ops/trace_bvh4).
    """
    node_min, node_max = refit_bvh4.refit_nodes(bvh, scene.aabb_min, scene.aabb_max)
    return bvh.replace(node_aabb_min=node_min, node_aabb_max=node_max)
