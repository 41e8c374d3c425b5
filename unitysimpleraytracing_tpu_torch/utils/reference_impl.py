"""Scalar CPU replica of the reference renderer's device algorithms.

The reference validates its HLSL with CPU duplicates
(``Assets/_Scripts/_debug/_debugRayBoxIntersectionTester.cs:33-67`` replicates
the slab test in C#).  This module extends that pattern to the whole pipeline:
straight-line numpy/Python transcriptions of the Karras build and the
stack-based traversal, preserving exact visit order — the oracle that the
vectorized operators and the CUDA kernels must match bit-for-bit, including
DFS tie-breaking.

The port's own copy of ``unitysimpleraytracing_tpu/utils/reference_impl.py``
(pure numpy, the same code), so the port's tests need nothing of the JAX
package for their oracle; ``tests/test_torch_aux.py`` holds the two copies
equal.  Intentionally slow and simple; used only by tests on small scenes.
"""
from __future__ import annotations

import numpy as np

MAX_FLOAT = np.float32(3.4028234663852886e38)


def clz32(v: int) -> int:
    v = int(v) & 0xFFFFFFFF
    if v == 0:
        return 32
    return 31 - v.bit_length() + 1


def karras_topology(codes: np.ndarray, n: int):
    """BVH.compute:94-149 transcribed; returns per-internal-node links
    (+ each node's covered leaf range [first, last] from DetermineRange)."""
    codes = np.asarray(codes, np.uint32)

    def delta(x, y):
        if 0 <= x <= n - 1 and 0 <= y <= n - 1:
            return clz32(int(codes[x]) ^ int(codes[y]))
        return -1

    left = np.full(n - 1, -1, np.int64)
    right = np.full(n - 1, -1, np.int64)
    lleaf = np.zeros(n - 1, bool)
    rleaf = np.zeros(n - 1, bool)
    iparent = np.full(n - 1, -1, np.int64)
    lparent = np.full(n, -1, np.int64)
    firsts = np.full(n - 1, -1, np.int64)
    lasts = np.full(n - 1, -1, np.int64)

    for i in range(n - 1):
        d = int(np.sign(delta(i, i + 1) - delta(i, i - 1)))
        dmin = delta(i, i - d)
        lmax = 2
        while delta(i, i + lmax * d) > dmin:
            lmax *= 2
        l = 0
        t = lmax // 2
        while t >= 1:
            if delta(i, i + (l + t) * d) > dmin:
                l += t
            t //= 2
        j = i + l * d
        first, last = min(i, j), max(i, j)
        firsts[i], lasts[i] = first, last

        first_code = int(codes[first])
        last_code = int(codes[last])
        if first_code == last_code:
            split = (first + last) >> 1
        else:
            common = clz32(first_code ^ last_code)
            split = first
            step = last - first
            while True:
                step = (step + 1) >> 1
                new_split = split + step
                if new_split < last:
                    if clz32(first_code ^ int(codes[new_split])) > common:
                        split = new_split
                if step <= 1:
                    break

        left[i], right[i] = split, split + 1
        if split == first:
            lleaf[i] = True
            lparent[split] = i
        else:
            iparent[split] = i
        if split + 1 == last:
            rleaf[i] = True
            lparent[split + 1] = i
        else:
            iparent[split + 1] = i
    return left, right, lleaf, rleaf, iparent, lparent, firsts, lasts


def ray_box(bmin, bmax, origin, inv_dir) -> bool:
    """Raytracing.compute:75-87 with D3D min/max NaN semantics."""
    with np.errstate(invalid="ignore", over="ignore"):
        t1 = (bmin - origin) * inv_dir
        t2 = (bmax - origin) * inv_dir

    def d3dmin(a, b):
        return np.where(np.isnan(a), b, np.where(np.isnan(b), a, np.minimum(a, b)))

    def d3dmax(a, b):
        return np.where(np.isnan(a), b, np.where(np.isnan(b), a, np.maximum(a, b)))

    tmin3 = d3dmin(t1, t2)
    tmax3 = d3dmax(t1, t2)
    tmin = d3dmax(tmin3[0], d3dmax(tmin3[1], tmin3[2]))
    tmax = d3dmin(tmax3[0], d3dmin(tmax3[1], tmax3[2]))
    return bool(tmax > tmin and tmax > 0)


def ray_triangle(orig, dirn, v0, v1, v2):
    """Raytracing.compute:37-73. Returns (t, u, v); t=MAX_FLOAT on reject."""
    e1 = (v1 - v0).astype(np.float32)
    e2 = (v2 - v0).astype(np.float32)
    pvec = np.cross(dirn, e2).astype(np.float32)
    det = np.float32(np.dot(e1, pvec))
    if det < 1e-8 and det > -1e-8:
        return MAX_FLOAT, np.float32(0), np.float32(0)
    inv_det = np.float32(1.0) / det
    tvec = (orig - v0).astype(np.float32)
    u = np.float32(np.dot(tvec, pvec)) * inv_det
    if u < 0 or u > 1:
        return MAX_FLOAT, np.float32(0), np.float32(0)
    qvec = np.cross(tvec, e1).astype(np.float32)
    v = np.float32(np.dot(dirn, qvec)) * inv_det
    if v < 0 or u + v > 1:
        return MAX_FLOAT, np.float32(0), np.float32(0)
    t = np.float32(np.dot(e2, qvec)) * inv_det
    return t, u, v


def traverse_one_ray(
    origin,
    dirn,
    node_min,
    node_max,
    left,
    right,
    lleaf,
    rleaf,
    sorted_tri,
    tri_min,
    tri_max,
    tri_a,
    tri_b,
    tri_c,
):
    """Raytracing.compute:129-176 transcribed: explicit stack DFS, exact visit
    order, strict-< acceptance. Returns (t, tri_index, u, v)."""
    origin = np.asarray(origin, np.float32)
    dirn = np.asarray(dirn, np.float32)
    with np.errstate(divide="ignore"):
        inv_dir = np.float32(1.0) / dirn

    best_t = MAX_FLOAT
    best_tri = 0
    best_u = np.float32(0)
    best_v = np.float32(0)

    def check_triangle(tri_idx):
        nonlocal best_t, best_tri, best_u, best_v
        if ray_box(tri_min[tri_idx], tri_max[tri_idx], origin, inv_dir):
            t, u, v = ray_triangle(
                origin, dirn, tri_a[tri_idx], tri_b[tri_idx], tri_c[tri_idx]
            )
            if t < best_t:
                best_t, best_tri, best_u, best_v = t, tri_idx, u, v

    stack = [0]
    while stack:
        index = stack.pop()
        if not ray_box(node_min[index], node_max[index], origin, inv_dir):
            continue
        if not lleaf[index]:
            stack.append(left[index])
        else:
            check_triangle(int(sorted_tri[left[index]]))
        if not rleaf[index]:
            stack.append(right[index])
        else:
            check_triangle(int(sorted_tri[right[index]]))
    return best_t, best_tri, best_u, best_v
