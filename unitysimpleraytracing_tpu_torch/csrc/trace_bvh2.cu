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
// What bounds it on an NVIDIA H100 80GB HBM3 at 700 W
// (benchmarks/kernel_ab.py, 2,027,520 primary rays over the default tree of
// 260,642 triangles, 7.07 records a ray): not bytes (a warm L2 is within 1 %
// of a cold one) and not one fetch's latency, but the walk's chain of
// dependent steps: stack -> record -> slab tests -> next record, 1.7 times
// as many steps as the BVH4 kernel's, each a shorter one, with the lanes of
// a 32-ray warp 71 % busy: 0.19 ms against a 0.030 ms bound (bytes;
// operations at the no-FMA rate 0.023).  The design keeps that chain short:
// the near child is popped straight back on most internal steps, so it stays
// in a register as the record popped next instead of a local store and a
// dependent local load (-4 to -6 % against pushing it); boxes and metas are
// four 16-byte read-only loads a pop; a record whose slab test passed a leaf
// child reads its two triangles as four more 16-byte loads (slots 16-31 are
// aligned), one burst in place of nine 4-byte loads a leaf (a further 0 to
// -3 %, and most of the -11 % at 1,048,352 triangles, whose table does not
// fit in L2); rays arrive in 32x32 tile-major order, 32 of one pixel row to
// a warp; 128-thread blocks (56 registers, no spill: 36 resident warps a
// SM).  More resident warps bought with spills (40 or 32 registers), the
// next record's loads issued before this record's leaf tests (70
// registers), and the metas decoded by an exact add of 2^23 in place of the
// float-to-int conversion each tied or lost.
//
// Arithmetic contract: compiled with -fmad=false and without fast-math, every
// product and sum below is a separate IEEE float32 operation in the order
// written.  The plain PyTorch version (traverse_bvh2_plain) does the same
// operations in the same order, so the two agree bit for bit, records popped
// per ray included.  fminf/fmaxf return the non-NaN operand: the D3D min/max
// rule of the original shader.

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

// Moller-Trumbore on one leaf child's vertices a, b, c; keeps the hit when it
// is accepted and nearer than t.  No t > 0 test; accept on strict <.
__device__ __forceinline__ void leaf_test(
    float ax, float ay, float az, float bx, float by, float bz,
    float cx, float cy, float cz,
    float ox, float oy, float oz, float dx, float dy, float dz, int id,
    float& t, int& tri, float& u, float& v)
{
    const float e1x = bx - ax;
    const float e1y = by - ay;
    const float e1z = bz - az;
    const float e2x = cx - ax;
    const float e2y = cy - ay;
    const float e2z = cz - az;
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
        tri = id;
        u = uu;
        v = vv;
    }
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
    int k = 0;                           // the record popped next
    int sp = 0;                          // entries on the stack below k

    while (true) {
        ++steps;
        const float4* rec = table + (size_t)k * 8;

        // Slots 0-15: both boxes, both metas and the left triangle's first
        // two floats.
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

        // Leaf children, left then right, each gated by its own slab mask.
        // Slots 16-31 are four aligned float4s: the left triangle is b[14],
        // b[15], rec[4] and rec[5].xyz, the right one rec[5].w, rec[6], rec[7].
        const bool test_l = hit[0] && leaf[0];
        const bool test_r = hit[1] && leaf[1];
        if (test_l || test_r) {
            const float4 q4 = __ldg(rec + 4);
            const float4 q5 = __ldg(rec + 5);
            const float4 q6 = __ldg(rec + 6);
            const float4 q7 = __ldg(rec + 7);
            if (test_l) {
                leaf_test(b[14], b[15], q4.x, q4.y, q4.z, q4.w, q5.x, q5.y, q5.z,
                          ox, oy, oz, dx, dy, dz, idx[0], t, tri, u, v);
            }
            if (test_r) {
                leaf_test(q5.w, q6.x, q6.y, q6.z, q6.w, q7.x, q7.y, q7.z, q7.w,
                          ox, oy, oz, dx, dy, dz, idx[1], t, tri, u, v);
            }
        }

        // Any-hit: a positive threshold retires the ray at its first
        // accepted hit below it, with t collapsed to 0.
        if ((thr > 0.0f) && (t < thr)) {
            t = 0.0f;
            break;
        }

        // Push internal children far then near; a leaf child was tested in
        // place and is never pushed.  The near one, pushed last, is the next
        // pop, so it goes to k and not through the stack.
        const bool push_l = hit[0] && !leaf[0];
        const bool push_r = hit[1] && !leaf[1];
        const bool l_near = axis == 0 ? near_x : (axis == 1 ? near_y : near_z);
        // A tree deeper than the stack allows is an error, never a silent
        // overwrite (net growth is at most 1 per record).  With k held in a
        // register the stack holds one entry less than a push-all-then-pop
        // walk's; the test is that walk's.
        if (sp + (int)push_l + (int)push_r > STACK_DEPTH) __trap();
        if (push_l && push_r) {
            stack[sp++] = l_near ? idx[1] : idx[0];
            k = l_near ? idx[0] : idx[1];
        } else if (push_l) {
            k = idx[0];
        } else if (push_r) {
            k = idx[1];
        } else if (sp > 0) {
            k = stack[--sp];
        } else {
            break;
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
