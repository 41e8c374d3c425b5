"""Batched per-ray BVH2 traversal (the oracle), brute force, shading.

The reference traverses per-pixel with an explicit ``uint stack[64]`` DFS in
one GPU thread per ray (``Raytracing.compute:105-176``).  `traverse` is the
lock-step batched form of that loop: every ray in the batch carries its own
stack row in a (R, 64) tensor, and one iteration performs one stack pop for
every still-active ray with masked updates.  The pop/push/intersect sequence
inside an iteration is ordered exactly like the reference body (box-test
popped node → left child: push or intersect → right child: push or
intersect), so nearest-hit tie-breaking ("first visited wins", strict ``<`` at
Raytracing.compute:95) is that of the reference.  It is the oracle the BVH4
traversal is held against; the main path does not run it.

The hit result is (t, tri, u, v); ``tri`` stays 0 on miss and shading then
reads triangle 0's data, matching Raytracing.compute:129-131,178-184.
"""
from __future__ import annotations

import torch

from unitysimpleraytracing_tpu_torch import constants as C
from unitysimpleraytracing_tpu_torch.core.texture import Texture, sample_bilinear
from unitysimpleraytracing_tpu_torch.core.types import Bvh, HitRecord, Scene
from unitysimpleraytracing_tpu_torch.ops.intersect import ray_box, ray_triangle


def _check_triangle(scene: Scene, tri_idx, mask, origins, dirs, inv_dirs, state):
    """CheckTriangle (Raytracing.compute:89-103): triangle-AABB pre-test, then
    Möller–Trumbore; accept strictly closer hits only, masked by ``mask``."""
    t_cur, tri_cur, u_cur, v_cur = state
    idx = tri_idx.to(torch.int64)
    box_ok = ray_box(scene.aabb_min[idx], scene.aabb_max[idx], origins, inv_dirs)
    t_new, u_new, v_new = ray_triangle(
        origins,
        dirs,
        scene.triangles.a[idx],
        scene.triangles.b[idx],
        scene.triangles.c[idx],
    )
    accept = mask & box_ok & (t_new < t_cur)
    t = torch.where(accept, t_new, t_cur)
    tri = torch.where(accept, tri_idx, tri_cur)
    u = torch.where(accept, u_new, u_cur)
    v = torch.where(accept, v_new, v_cur)
    return t, tri, u, v


def _stack_write(stack, pos, value, mask):
    """stack[r, pos[r]] = value[r] where mask[r] — in place (the stack is
    private to the traversal; rewriting it whole each step would copy
    (R, 64) words per push)."""
    rows = mask.nonzero(as_tuple=True)[0]
    stack[rows, pos[rows]] = value[rows]


@torch.no_grad()
def traverse(
    scene: Scene, bvh: Bvh, origins: torch.Tensor, dirs: torch.Tensor
) -> HitRecord:
    """Nearest-hit BVH traversal for a batch of rays.

    origins/dirs: (R, 3) f32, dirs unit length. Returns HitRecord over R rays.
    """
    R = origins.shape[0]
    dev = origins.device
    cap = bvh.capacity
    inv_dirs = 1.0 / dirs

    stack = torch.zeros((R, C.TRAVERSAL_STACK_DEPTH), dtype=torch.int32, device=dev)
    sp = torch.ones((R,), dtype=torch.int64, device=dev)  # stack = [root]
    t = torch.full((R,), C.MAX_FLOAT, dtype=torch.float32, device=dev)
    tri = torch.zeros((R,), dtype=torch.int32, device=dev)
    u = torch.zeros((R,), dtype=torch.float32, device=dev)
    v = torch.zeros((R,), dtype=torch.float32, device=dev)

    while bool(torch.any(sp > 0)):
        active = sp > 0
        spm1 = torch.clamp(sp - 1, min=0)
        node = torch.gather(stack, 1, spm1[:, None])[:, 0]
        node = node.clamp(0, cap - 1).to(torch.int64)

        box_ok = ray_box(
            bvh.node_aabb_min[node], bvh.node_aabb_max[node], origins, inv_dirs
        )
        proceed = active & box_ok

        left = bvh.left[node].clamp(0, cap - 1)
        right = bvh.right[node].clamp(0, cap - 1)
        left_leaf = bvh.left_is_leaf[node]
        right_leaf = bvh.right_is_leaf[node]

        # Left child: push internal / intersect leaf (Raytracing.compute:148-159).
        push_l = proceed & ~left_leaf
        _stack_write(stack, spm1, left, push_l)
        sp_l = spm1 + push_l
        tri_l = bvh.sorted_tri[left.to(torch.int64)]
        t, tri, u, v = _check_triangle(
            scene, tri_l, proceed & left_leaf, origins, dirs, inv_dirs, (t, tri, u, v)
        )

        # Right child (Raytracing.compute:161-175).
        push_r = proceed & ~right_leaf
        _stack_write(stack, sp_l, right, push_r)
        sp_r = sp_l + push_r
        tri_r = bvh.sorted_tri[right.to(torch.int64)]
        t, tri, u, v = _check_triangle(
            scene, tri_r, proceed & right_leaf, origins, dirs, inv_dirs, (t, tri, u, v)
        )

        sp = torch.where(active, sp_r, sp)

    return HitRecord(t=t, tri=tri, u=u, v=v)


@torch.no_grad()
def brute_force_trace(
    scene: Scene, origins: torch.Tensor, dirs: torch.Tensor, chunk: int = 1024
) -> HitRecord:
    """Oracle: test every ray against every real triangle, in ascending
    triangle-id order with strict-< acceptance and the same AABB pre-test.

    Vectorized over chunks of ``chunk`` triangles: within a chunk the first
    index attaining the minimum wins (lowest triangle id among equal t), and
    the chunk's winner replaces the running hit only when strictly closer —
    the same result as the one-triangle-at-a-time loop.

    Matches `traverse` everywhere hit distances are untied (ties may resolve
    differently since DFS visit order ≠ id order); tests use tie-free scenes.
    """
    R = origins.shape[0]
    dev = origins.device
    inv_dirs = 1.0 / dirs
    n = scene.count
    tris = scene.triangles

    t = torch.full((R,), C.MAX_FLOAT, dtype=torch.float32, device=dev)
    tri = torch.zeros((R,), dtype=torch.int32, device=dev)
    u = torch.zeros((R,), dtype=torch.float32, device=dev)
    v = torch.zeros((R,), dtype=torch.float32, device=dev)
    o, d, inv = origins[:, None, :], dirs[:, None, :], inv_dirs[:, None, :]
    rows = torch.arange(R, device=dev)

    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        box_ok = ray_box(scene.aabb_min[None, lo:hi], scene.aabb_max[None, lo:hi], o, inv)
        t_new, u_new, v_new = ray_triangle(
            o, d, tris.a[None, lo:hi], tris.b[None, lo:hi], tris.c[None, lo:hi]
        )
        # A NaN t never wins the strict-< compare: treat it as a miss.
        t_new = torch.where(box_ok & ~torch.isnan(t_new), t_new, C.MAX_FLOAT)
        best = torch.argmin(t_new, dim=1)
        t_best = t_new[rows, best]
        accept = t_best < t
        t = torch.where(accept, t_best, t)
        tri = torch.where(accept, (best + lo).to(torch.int32), tri)
        u = torch.where(accept, u_new[rows, best], u)
        v = torch.where(accept, v_new[rows, best], v)
    return HitRecord(t=t, tri=tri, u=u, v=v)


@torch.no_grad()
def shade(
    scene: Scene, tex: Texture, hits: HitRecord, shadow: torch.Tensor | None = None
) -> torch.Tensor:
    """Lambert shading + texture (Raytracing.compute:178-184): barycentric
    UV/normal interpolation (normals NOT renormalized), bilinear sample,
    ``max(0.4, dot(L, N))`` with L = normalize(1,1,1); alpha = hit flag.

    ``shadow`` (R,) bool — optional occlusion mask from a shadow-ray pass
    (a capability beyond the reference): shadowed pixels drop to the
    reference's 0.4 ambient floor.
    """
    tri = hits.tri.to(torch.int64)
    w = (1.0 - hits.u - hits.v)[:, None]
    bu, bv = hits.u[:, None], hits.v[:, None]
    t = scene.triangles
    uv = w * t.a_uv[tri] + bu * t.b_uv[tri] + bv * t.c_uv[tri]
    normal = w * t.a_normal[tri] + bu * t.b_normal[tri] + bv * t.c_normal[tri]
    inv_sqrt3 = 1.0 / torch.sqrt(torch.tensor(3.0, dtype=torch.float32, device=w.device))
    lambert = torch.clamp(
        inv_sqrt3 * (normal[:, 0] + normal[:, 1] + normal[:, 2]), min=0.4
    )
    if shadow is not None:
        lambert = torch.where(shadow, 0.4, lambert)
    texel = sample_bilinear(tex, uv[:, 0], uv[:, 1])
    rgb = texel[:, :3] * lambert[:, None]
    alpha = hits.hit.to(torch.float32)
    return torch.cat([rgb, alpha[:, None]], dim=1)


@torch.no_grad()
def compose(background_rgb: torch.Tensor, traced_rgba: torch.Tensor) -> torch.Tensor:
    """ImageComposer.shader:44-53: lerp(raster, traced, traced.a), alpha 1."""
    a = traced_rgba[..., 3:4]
    rgb = background_rgb[..., :3] * (1.0 - a) + traced_rgba[..., :3] * a
    return torch.cat([rgb, torch.ones_like(a)], dim=-1)
