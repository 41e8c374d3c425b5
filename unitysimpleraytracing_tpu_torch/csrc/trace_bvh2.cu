// Binary-record (BVH2) nearest-hit / any-hit traversal, one thread per ray,
// for sm_90a.
//
// Replaces the TPU kernel ops/trace_pallas.py::_make_kernel of the JAX
// package.  It computes the same function — a child-pair depth-first walk over
// the (cap, 32) float32 record table of ops/trace_bvh2.py, with the exact
// t-cull and near-child-first order — in the form natural to this card and to
// the original renderer (Raytracing.compute: one thread per pixel): every ray
// owns a private stack of node ids and orders the two children of a record by
// its own direction sign on the record's split axis, where the TPU kernel
// shared one stack and one direction vote per packet of rays.  The TPU
// kernel's record layouts of 2 and 4 per row, its multi-pop step and its
// packet interleave answer that machine's memory and have no counterpart.
//
// Record layout (32 floats = 128 bytes = 8 float4):
//   [0, 6)    left child box (minx, miny, minz, maxx, maxy, maxz)
//   [6, 12)   right child box
//   [12]      lmeta = idx | leaf << 20             stored as an exact float
//   [13]      rmeta = idx | leaf << 20 | axis << 21
//   [14, 23)  left leaf triangle a, b, c (zeros for an internal child)
//   [23, 32)  right leaf triangle a, b, c
//
// What bounds it: the walk is a chain of dependent 128-byte record fetches (a
// pop cannot start before the previous record's slab tests are done), so
// it is latency bound on the L2/HBM path, not bandwidth or FLOP bound.  The
// design reads boxes and metas with four 16-byte read-only loads per pop,
// fetches the 36 bytes of a leaf triangle only when that child's slab test
// passed, and relies on rays arriving in 32x32 tile-major order so the lanes
// of a warp touch the same records and the table stays in L1/L2.
//
// Arithmetic contract: compiled with -fmad=false and without fast-math, every
// product and sum below is a separate IEEE float32 operation in the order
// written.  The plain PyTorch version (traverse_bvh2_plain) does the same
// operations in the same order, so the two agree bit for bit.  fminf/fmaxf
// return the non-NaN operand: the D3D min/max rule of the original shader.

#include <cuda_runtime.h>

#define STACK_DEPTH 64
#define BLOCK_THREADS 128
#define IDX_BITS 20
#define IDX_MASK ((1 << IDX_BITS) - 1)

__device__ __forceinline__ bool slab_test(
    const float* b, float ox, float oy, float oz,
    float ix, float iy, float iz, float t_cur)
{
    const float t1x = (b[0] - ox) * ix;
    const float t2x = (b[3] - ox) * ix;
    const float t1y = (b[1] - oy) * iy;
    const float t2y = (b[4] - oy) * iy;
    const float t1z = (b[2] - oz) * iz;
    const float t2z = (b[5] - oz) * iz;
    const float tmin = fmaxf(fminf(t1x, t2x), fmaxf(fminf(t1y, t2y), fminf(t1z, t2z)));
    const float tmax = fminf(fmaxf(t1x, t2x), fminf(fmaxf(t1y, t2y), fmaxf(t1z, t2z)));
    return (tmax > tmin) && (tmax > 0.0f) && (tmin < t_cur);
}

__global__ void __launch_bounds__(BLOCK_THREADS)
trace_bvh2_kernel(
    const float4* __restrict__ table,
    const float* __restrict__ origins,
    const float* __restrict__ dirs,
    const float* __restrict__ t_init,   // may be null: start at MAX_FLOAT
    const float* __restrict__ thresh,   // may be null: any-hit off
    float* __restrict__ out_t,
    int* __restrict__ out_tri,
    float* __restrict__ out_u,
    float* __restrict__ out_v,
    int* __restrict__ out_steps,        // may be null
    int n_rays)
{
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= n_rays) return;

    const float ox = origins[3 * r + 0];
    const float oy = origins[3 * r + 1];
    const float oz = origins[3 * r + 2];
    const float dx = dirs[3 * r + 0];
    const float dy = dirs[3 * r + 1];
    const float dz = dirs[3 * r + 2];
    const float ix = 1.0f / dx;
    const float iy = 1.0f / dy;
    const float iz = 1.0f / dz;
    // "Left is near" on an axis iff this ray travels in +axis.
    const bool near_x = dx > 0.0f;
    const bool near_y = dy > 0.0f;
    const bool near_z = dz > 0.0f;

    float t = t_init ? t_init[r] : 3.4028234663852886e38f;
    const float thr = thresh ? thresh[r] : 0.0f;
    int tri = 0;
    float u = 0.0f;
    float v = 0.0f;
    int steps = 0;

    int stack[STACK_DEPTH];
    int sp = 1;
    stack[0] = 0;

    while (sp > 0) {
        const int k = stack[--sp];
        ++steps;
        const float4* rec = table + (size_t)k * 8;

        // Slots 0-15: both boxes, both metas (and the first two floats of
        // the left triangle, re-read below only if that leaf is tested).
        float b[16];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float4 q = __ldg(rec + i);
            b[4 * i + 0] = q.x;
            b[4 * i + 1] = q.y;
            b[4 * i + 2] = q.z;
            b[4 * i + 3] = q.w;
        }
        // Metas are integers below 2^24 stored as floats: the cast is exact.
        const int lmi = (int)b[12];
        const int rmi = (int)b[13];
        const int idx[2] = {lmi & IDX_MASK, rmi & IDX_MASK};
        // lmeta holds nothing above its leaf bit; rmeta holds the axis there.
        const bool leaf[2] = {(lmi >> IDX_BITS) == 1, ((rmi >> IDX_BITS) & 1) == 1};
        const int axis = rmi >> (IDX_BITS + 1);

        // Both slab tests see the running t as it was at the pop.
        const bool hit[2] = {
            slab_test(b + 0, ox, oy, oz, ix, iy, iz, t),
            slab_test(b + 6, ox, oy, oz, ix, iy, iz, t),
        };

        // Leaf children, left then right: Moller-Trumbore on the embedded
        // vertices, gated by the child's own slab mask.  No t > 0 test;
        // accept on strict <.
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            if (hit[c] && leaf[c]) {
                const float* vp = reinterpret_cast<const float*>(rec) + 14 + 9 * c;
                const float ax = __ldg(vp + 0), ay = __ldg(vp + 1), az = __ldg(vp + 2);
                const float e1x = __ldg(vp + 3) - ax;
                const float e1y = __ldg(vp + 4) - ay;
                const float e1z = __ldg(vp + 5) - az;
                const float e2x = __ldg(vp + 6) - ax;
                const float e2y = __ldg(vp + 7) - ay;
                const float e2z = __ldg(vp + 8) - az;
                const float px = dy * e2z - dz * e2y;
                const float py = dz * e2x - dx * e2z;
                const float pz = dx * e2y - dy * e2x;
                const float det = e1x * px + e1y * py + e1z * pz;
                const float inv_det = 1.0f / det;
                const float tvx = ox - ax, tvy = oy - ay, tvz = oz - az;
                const float uu = (tvx * px + tvy * py + tvz * pz) * inv_det;
                const float qx = tvy * e1z - tvz * e1y;
                const float qy = tvz * e1x - tvx * e1z;
                const float qz = tvx * e1y - tvy * e1x;
                const float vv = (dx * qx + dy * qy + dz * qz) * inv_det;
                const float tn = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
                const bool reject =
                    ((det < 1e-8f) && (det > -1e-8f)) ||
                    ((uu < 0.0f) || (uu > 1.0f)) ||
                    ((vv < 0.0f) || (uu + vv > 1.0f));
                if (!reject && (tn < t)) {
                    t = tn;
                    tri = idx[c];
                    u = uu;
                    v = vv;
                }
            }
        }

        // Any-hit: a positive threshold retires the ray at its first
        // accepted hit below it, with t collapsed to 0.
        if ((thr > 0.0f) && (t < thr)) {
            t = 0.0f;
            break;
        }

        // Push internal children far then near; a leaf child was tested in
        // place and is never pushed.
        const bool push_l = hit[0] && !leaf[0];
        const bool push_r = hit[1] && !leaf[1];
        const bool l_near = axis == 0 ? near_x : (axis == 1 ? near_y : near_z);
        // A tree deeper than the stack allows is an error, never a silent
        // overwrite (net growth is at most 1 per record).
        if (sp + (int)push_l + (int)push_r > STACK_DEPTH) __trap();
        if (push_l && push_r) {
            stack[sp++] = l_near ? idx[1] : idx[0];
            stack[sp++] = l_near ? idx[0] : idx[1];
        } else if (push_l) {
            stack[sp++] = idx[0];
        } else if (push_r) {
            stack[sp++] = idx[1];
        }
    }

    out_t[r] = t;
    out_tri[r] = tri;
    out_u[r] = u;
    out_v[r] = v;
    if (out_steps) out_steps[r] = steps;
}

// Plain C entry point, bound with ctypes.  Launches on the given stream, does
// not synchronise, allocates nothing; returns cudaGetLastError() as an int.
extern "C" int trace_bvh2_launch(
    const void* table, const void* origins, const void* dirs,
    const void* t_init, const void* thresh,
    void* out_t, void* out_tri, void* out_u, void* out_v, void* out_steps,
    int n_rays, void* stream)
{
    if (n_rays <= 0) return (int)cudaErrorInvalidValue;
    const int blocks = (n_rays + BLOCK_THREADS - 1) / BLOCK_THREADS;
    trace_bvh2_kernel<<<blocks, BLOCK_THREADS, 0, (cudaStream_t)stream>>>(
        (const float4*)table, (const float*)origins, (const float*)dirs,
        (const float*)t_init, (const float*)thresh,
        (float*)out_t, (int*)out_tri, (float*)out_u, (float*)out_v,
        (int*)out_steps, n_rays);
    return (int)cudaGetLastError();
}
