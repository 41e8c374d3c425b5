// BVH4 nearest-hit / any-hit traversal, one thread per ray, for sm_90a.
//
// Replaces the TPU kernel ops/trace_pallas4.py::_make_kernel4 of the JAX
// package.  It computes the same function — a depth-first walk over the
// (cap4, 64) float32 record table of ops/trace_bvh4.py — in the form natural
// to this card and to the original renderer (Raytracing.compute: one thread
// per pixel): every ray owns a private stack of record ids and makes its own
// near/far decision from its own direction signs, where the TPU kernel shared
// one stack and one direction vote per packet of rays.
//
// Record layout (64 floats = 256 bytes = 16 float4):
//   [0, 24)   four child boxes, each (minx, miny, minz, maxx, maxy, maxz)
//   [24, 28)  four metas stored as floats: idx | leaf << 21 | axis << 22
//   [28, 64)  four pre-differenced triangles, each (a, e1 = b - a, e2 = c - a)
//
// What bounds it on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py,
// 2,027,520 primary rays over the default tree of 260,642 triangles): not
// the bytes it loads (112 a pop, 36 a leaf test: 1.0 GB, which arrive at
// about 4.5 TB/s from the caches), not L2 (a cold L2 costs nothing over a
// warm one) and not one fetch's latency (benchmarks/kernel_probe.py), but
// the walk's chain of dependent steps: stack -> record -> slab tests -> next
// record, with the lanes of a 32-ray warp 74 % busy: 0.22 ms against a
// 0.030 ms bound (bytes; operations at the no-FMA rate 0.028).  The design:
// one thread per ray; the record popped next stays in a register instead of
// being pushed and popped straight back (a local store and a dependent local
// load fewer on most pops; benchmarks/kernel_ab.py times it against the
// first kernel); boxes and metas as seven 16-byte read-only loads; a leaf's
// 36 bytes as nine 4-byte loads, only when its slab test passed; rays in
// 32x32 tile-major order, 32 of one pixel row to a warp; 128-thread blocks
// (55 registers, no spill: 36 resident warps a SM).
//
// Arithmetic contract: compiled with -fmad=false and without fast-math, every
// product and sum below is a separate IEEE float32 operation in the order
// written.  The plain PyTorch version (traverse_bvh4_plain) does the same
// operations in the same order, so the two agree bit for bit.  fminf/fmaxf
// return the non-NaN operand: the D3D min/max rule of the original shader.

#include <cuda_runtime.h>

#define STACK_DEPTH 64
#define BLOCK_THREADS 128
#define IDX_MASK ((1 << 21) - 1)

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
trace_bvh4_kernel(
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
    int k = 0;                           // the record popped next
    int sp = 0;                          // entries on the stack below k

    while (true) {
        ++steps;
        const float4* rec = table + (size_t)k * 16;

        float b[24];
#pragma unroll
        for (int i = 0; i < 6; ++i) {
            const float4 q = __ldg(rec + i);
            b[4 * i + 0] = q.x;
            b[4 * i + 1] = q.y;
            b[4 * i + 2] = q.z;
            b[4 * i + 3] = q.w;
        }
        const float4 mq = __ldg(rec + 6);
        // Metas are integers below 2^24 stored as floats: the cast is exact.
        const int m[4] = {(int)mq.x, (int)mq.y, (int)mq.z, (int)mq.w};

        // All four slab tests see the running t as it was at the pop.
        bool hit[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            hit[e] = slab_test(b + 6 * e, ox, oy, oz, ix, iy, iz, t);
        }

        // Leaf entries: Moller-Trumbore on (a, e1, e2), in entry order.
        // No t > 0 test; accept on strict <.  EMPTY entries carry an
        // inverted box (slab fails) and zero vertices (det == 0 rejects).
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            if (hit[e] && ((m[e] >> 21) & 1)) {
                const float* vp = reinterpret_cast<const float*>(rec) + 28 + 9 * e;
                const float ax = __ldg(vp + 0), ay = __ldg(vp + 1), az = __ldg(vp + 2);
                const float e1x = __ldg(vp + 3), e1y = __ldg(vp + 4), e1z = __ldg(vp + 5);
                const float e2x = __ldg(vp + 6), e2y = __ldg(vp + 7), e2z = __ldg(vp + 8);
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
                    tri = m[e] & IDX_MASK;
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

        // Internal entries far-to-near.  Pair order by the record's own split
        // axis (meta 0), order inside each pair by that child's split axis
        // (metas 1 and 2), each against this ray's direction sign.
        const int a_self = m[0] >> 22;
        const int a_l = m[1] >> 22;
        const int a_r = m[2] >> 22;
        const bool n_pair = a_self == 0 ? near_x : (a_self == 1 ? near_y : near_z);
        const bool n_l = a_l == 0 ? near_x : (a_l == 1 ? near_y : near_z);
        const bool n_r = a_r == 0 ? near_x : (a_r == 1 ? near_y : near_z);
        int id[4];
        bool push[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            id[e] = m[e] & IDX_MASK;
            push[e] = hit[e] && !((m[e] >> 21) & 1);
        }
        const int l0i = n_l ? id[0] : id[1];
        const bool l0p = n_l ? push[0] : push[1];
        const int l1i = n_l ? id[1] : id[0];
        const bool l1p = n_l ? push[1] : push[0];
        const int r0i = n_r ? id[2] : id[3];
        const bool r0p = n_r ? push[2] : push[3];
        const int r1i = n_r ? id[3] : id[2];
        const bool r1p = n_r ? push[3] : push[2];
        // Pop order s0, s1, s2, s3: the near pair first.
        const int s0i = n_pair ? l0i : r0i;
        const bool s0p = n_pair ? l0p : r0p;
        const int s1i = n_pair ? l1i : r1i;
        const bool s1p = n_pair ? l1p : r1p;
        const int s2i = n_pair ? r0i : l0i;
        const bool s2p = n_pair ? r0p : l0p;
        const int s3i = n_pair ? r1i : l1i;
        const bool s3p = n_pair ? r1p : l1p;
        // A tree deeper than the 64-entry stack allows is an error, never a
        // silent overwrite (net growth is at most 3 per record over at most 17
        // collapsed levels, so 64 entries suffice for 32-bit keys).  The entry
        // popped next stays in a register, so the stack holds one entry less
        // than a push-all-then-pop walk; the test is that walk's.
        if (sp + (int)s0p + (int)s1p + (int)s2p + (int)s3p > STACK_DEPTH) __trap();
        // Pushed in the order s3, s2, s1, s0; the last one pushed is the next
        // pop, so it goes to k and not through the stack.
        int next = -1;
        if (s3p) { next = s3i; }
        if (s2p) { if (next >= 0) stack[sp++] = next; next = s2i; }
        if (s1p) { if (next >= 0) stack[sp++] = next; next = s1i; }
        if (s0p) { if (next >= 0) stack[sp++] = next; next = s0i; }
        if (next >= 0) k = next;
        else if (sp > 0) k = stack[--sp];
        else break;
    }

    out_t[r] = t;
    out_tri[r] = tri;
    out_u[r] = u;
    out_v[r] = v;
    if (out_steps) out_steps[r] = steps;
}

// Plain C entry point, bound with ctypes.  Launches on the given stream, does
// not synchronise, allocates nothing; returns cudaGetLastError() as an int.
extern "C" int trace_bvh4_launch(
    const void* table, const void* origins, const void* dirs,
    const void* t_init, const void* thresh,
    void* out_t, void* out_tri, void* out_u, void* out_v, void* out_steps,
    int n_rays, void* stream)
{
    if (n_rays <= 0) return (int)cudaErrorInvalidValue;
    const int blocks = (n_rays + BLOCK_THREADS - 1) / BLOCK_THREADS;
    trace_bvh4_kernel<<<blocks, BLOCK_THREADS, 0, (cudaStream_t)stream>>>(
        (const float4*)table, (const float*)origins, (const float*)dirs,
        (const float*)t_init, (const float*)thresh,
        (float*)out_t, (int*)out_tri, (float*)out_u, (float*)out_v,
        (int*)out_steps, n_rays);
    return (int)cudaGetLastError();
}
