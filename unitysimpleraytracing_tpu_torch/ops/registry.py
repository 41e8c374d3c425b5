"""Operator/engine registry — the kernel-binding substrate.

Counterpart of ``unitysimpleraytracing_tpu/ops/registry.py`` and analog of the
reference's ``ShaderContainer`` (``Assets/_Scripts/ShaderContainer.cs:6-41``):
where Unity serializes five compute-shader asset references behind
``IShaderContainer`` and hands kernel handles to each pipeline stage, this
registry maps (stage, impl-name) to the callable engine, so orchestration
code selects implementations by name and new engines (a faster kernel, a
debug reference) register without touching call sites.

Stages and their engines — exactly what the port runs:

- ``sort``:     "torch" (stable ``torch.sort``), "radix" (the pass
                decomposition in plain tensor code), "cuda" (histogram, scan
                and rank kernels, ops/sort_radix_cuda)
- ``scan``:     "torch" (shifted cumsum), "cuda" (ops/scan)
- ``traverse``: "perray" (per-ray BVH2 stacks, ops/trace), "packet"
                (shared-stack packets, ops/trace_packet), "plain4" (BVH4
                records in plain tensor code), "cuda4" (the BVH4 kernel,
                ops/trace_bvh4 — the production engine), "plain2" and
                "cuda2" (binary records and their kernel, ops/trace_bvh2)
- ``topology``: "karras" (the reference's radix tree, ops/lbvh), "sah"
                (sweep SAH over the sorted order, ops/sah)
"""
from __future__ import annotations

import functools
from typing import Callable

_REGISTRY: dict[str, dict[str, Callable]] = {}


def register(stage: str, name: str, fn: Callable | None = None):
    """Register an engine; usable directly or as a decorator."""

    def _do(f):
        _REGISTRY.setdefault(stage, {})[name] = f
        return f

    return _do(fn) if fn is not None else _do


def get(stage: str, name: str) -> Callable:
    try:
        return _REGISTRY[stage][name]
    except KeyError:
        raise KeyError(
            f"no engine {name!r} for stage {stage!r}; "
            f"available: {sorted(_REGISTRY.get(stage, {}))}"
        ) from None


def engines(stage: str) -> list[str]:
    return sorted(_REGISTRY.get(stage, {}))


def stages() -> list[str]:
    return sorted(_REGISTRY)


def _register_builtins() -> None:
    """Bind the built-in engines."""
    from unitysimpleraytracing_tpu_torch.ops import (
        lbvh,
        sah,
        scan,
        sort,
        sort_radix_cuda,
        trace,
        trace_bvh2,
        trace_bvh4,
        trace_packet,
    )

    register("sort", "torch", functools.partial(sort.sort_key_val, impl="torch"))
    register("sort", "radix", sort.radix_sort_key_val)
    register("sort", "cuda", sort_radix_cuda.radix_sort_key_val_cuda)

    register("scan", "torch", scan.exclusive_scan_plain)
    register("scan", "cuda", scan.exclusive_scan)

    register("traverse", "perray", trace.traverse)
    register("traverse", "plain4", trace_bvh4.traverse_bvh4_plain)
    register("traverse", "cuda4", trace_bvh4.traverse_bvh4)
    register("traverse", "packet", trace_packet.traverse_packets)
    register("traverse", "plain2", trace_bvh2.traverse_bvh2_plain)
    register("traverse", "cuda2", trace_bvh2.traverse_bvh2)

    register("topology", "karras", lbvh.build_bvh_from_sorted)
    register("topology", "sah", sah.build_bvh_sah_from_sorted)


_register_builtins()
