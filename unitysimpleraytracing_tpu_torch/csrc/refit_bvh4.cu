// The animated frame's geometry update, for sm_90a: a bottom-up refit of the
// binary tree's node boxes, and the write of the BVH4 record table from the
// refitted boxes and the moved triangles.
//
// Replaces no TPU kernel.  The JAX package computes both steps as XLA
// operations (ops/lbvh.py's range-query refit, ops/trace_pallas4.py's
// pack_tables4), and so does the port's plain PyTorch version: a sparse
// table of 17 levels at 65,536 leaves (3 launches a level) and a
// concatenated (2 cap + 1, 15) source array gathered four times (35
// launches).  A frame of a deforming mesh repays both, so on the card they
// were 109 launches and about 0.3 ms of device time a frame (PERF.md).
// These two kernels are one launch each.
//
// refit_kernel.  The reference's own design (BVH.compute:172-220): one thread
// per sorted leaf position below count climbs its parent links.  At each
// internal node it draws an arrival ticket; the first arrival stops, the
// second reads the other child's box and writes the node's box, then goes on
// to the parent.  A box is a min and a max, and min and max are exact in
// float32, so the result does not depend on the order of arrival.  Both
// children are combined left first, as fmaxf(left, right) on the negated
// mins and on the maxes, and the min is negated back when it is written:
// the same operations the plain version (ops/lbvh.py::refit) applies over
// its windows, whose left window is combined first too, so even the sign
// of a zero comes out the same whichever way fmaxf breaks the tie.
// Rows from count - 1 up are written +0.0, as the plain version writes them.
//
// Arrival tickets need no reset.  Every call brings exactly two arrivals to
// each internal node of the tree, so a node's 32-bit counter is even between
// calls; an arrival that reads an even count is the first, an odd one the
// second.  The counters belong to one topology and one stream
// (ops/refit_bvh4.py), are zero-filled once when they are made, and the host
// passes nothing that changes from call to call.
//
// Memory order.  A thread writes a node's box, then __threadfence(), then
// draws the parent's ticket; the second arrival draws its ticket, then
// __threadfence(), then reads the first arrival's box through L2 (__ldcg),
// since L1 is not coherent between SMs.
//
// records_kernel.  One thread per (record row, entry) of the (cap4, 64)
// table: it reads its source index from the plan (a node box for src < cap,
// the triangle src - cap for src < 2 cap: its box and a, b - a, c - a; the
// inert EMPTY entry at 2 cap), writes the entry's six box slots widened by
// the cull margin, its nine vertex slots, and copies its meta.  The margin
// is computed in every thread from node 0's box with the float32 operations
// of ops/refit_bvh4.py::write_records_plain.  No intermediate array.
//
// What bounds them on an NVIDIA H100 80GB HBM3 at 700 W: not bytes (each
// input read once and each output written once: the refit 5.1 MB at 65,536
// rows, the records 15.5 MB at 32,769 records, 0.0015 and 0.0046 ms at
// 3.35 TB/s) but the refit's chain of dependent climbs, one level of the
// tree a step, each an atomic and an L2 read, and for both the launch:
// 0.046 ms for the refit and 0.026 ms for the records at 65,536 rows with a
// cold L2, against 0.308 and 0.148 ms for the plain pair
// (benchmarks/kernel_ab.py, case refit; PERF.md).
//
// Arithmetic contract: compiled with -fmad=false and without fast-math.  The
// refit only negates, compares and selects; the records subtract in float32
// as the plain version does, so kernel and plain version agree bit for bit.

#include <cuda_runtime.h>

#define THREADS 256
#define SLOTS 64
#define BIG 3.0e38f

__global__ void refit_kernel(
    const int* __restrict__ left, const int* __restrict__ right,
    const unsigned char* __restrict__ left_is_leaf,
    const unsigned char* __restrict__ right_is_leaf,
    const int* __restrict__ internal_parent, const int* __restrict__ leaf_parent,
    const int* __restrict__ sorted_tri,
    const float* __restrict__ tri_min, const float* __restrict__ tri_max,
    unsigned int* arrivals, float* node_min, float* node_max, int count, int cap)
{
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= cap) return;
    if (p >= count - 1) {
        for (int k = 0; k < 3; ++k) {
            node_min[3 * p + k] = 0.0f;
            node_max[3 * p + k] = 0.0f;
        }
    }
    if (p >= count) return;

    // The box this thread carries: the min negated, as the plain version
    // keeps it, and the max.
    const int tri = __ldg(sorted_tri + p);
    float lo[3], hi[3];
    for (int k = 0; k < 3; ++k) {
        lo[k] = -__ldg(tri_min + 3 * tri + k);
        hi[k] = __ldg(tri_max + 3 * tri + k);
    }
    int child = p;
    bool child_is_leaf = true;
    int node = __ldg(leaf_parent + p);
    while (node >= 0) {
        __threadfence();
        if ((atomicAdd(arrivals + node, 1u) & 1u) == 0u) return;  // first arrival
        __threadfence();
        const bool from_left =
            __ldg(left + node) == child && (__ldg(left_is_leaf + node) != 0) == child_is_leaf;
        const int sib = from_left ? __ldg(right + node) : __ldg(left + node);
        const bool sib_is_leaf =
            (from_left ? __ldg(right_is_leaf + node) : __ldg(left_is_leaf + node)) != 0;
        float slo[3], shi[3];
        if (sib_is_leaf) {
            const int t = __ldg(sorted_tri + sib);
            for (int k = 0; k < 3; ++k) {
                slo[k] = -__ldg(tri_min + 3 * t + k);
                shi[k] = __ldg(tri_max + 3 * t + k);
            }
        } else {
            for (int k = 0; k < 3; ++k) {
                slo[k] = -__ldcg(node_min + 3 * sib + k);
                shi[k] = __ldcg(node_max + 3 * sib + k);
            }
        }
        for (int k = 0; k < 3; ++k) {
            lo[k] = from_left ? fmaxf(lo[k], slo[k]) : fmaxf(slo[k], lo[k]);
            hi[k] = from_left ? fmaxf(hi[k], shi[k]) : fmaxf(shi[k], hi[k]);
            node_min[3 * node + k] = -lo[k];
            node_max[3 * node + k] = hi[k];
        }
        child = node;
        child_is_leaf = false;
        node = __ldg(internal_parent + node);
    }
}

__global__ void records_kernel(
    const long long* __restrict__ src_idx, const float* __restrict__ metas,
    const float* __restrict__ node_min, const float* __restrict__ node_max,
    const float* __restrict__ tri_min, const float* __restrict__ tri_max,
    const float* __restrict__ a, const float* __restrict__ b, const float* __restrict__ c,
    float* __restrict__ table, int rows, long long cap)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= 4 * rows) return;
    const int r = i >> 2;
    const int e = i & 3;

    // Cull margin from the root's box: max |coordinate|, less 8192, not
    // below 0, times 4e-6.
    float root = 0.0f;
    for (int k = 0; k < 3; ++k) root = fmaxf(root, fabsf(__ldg(node_min + k)));
    float root_hi = 0.0f;
    for (int k = 0; k < 3; ++k) root_hi = fmaxf(root_hi, fabsf(__ldg(node_max + k)));
    root = fmaxf(root, root_hi);
    const float widen = fmaxf(root - 8192.0f, 0.0f) * 4e-6f;

    const long long src = __ldg(src_idx + i);
    float lo[3], hi[3], v[9];
    if (src < cap) {
        for (int k = 0; k < 3; ++k) {
            lo[k] = __ldg(node_min + 3 * src + k);
            hi[k] = __ldg(node_max + 3 * src + k);
        }
        for (int k = 0; k < 9; ++k) v[k] = 0.0f;
    } else if (src < 2 * cap) {
        const long long t = src - cap;
        for (int k = 0; k < 3; ++k) {
            const float ak = __ldg(a + 3 * t + k);
            lo[k] = __ldg(tri_min + 3 * t + k);
            hi[k] = __ldg(tri_max + 3 * t + k);
            v[k] = ak;
            v[3 + k] = __ldg(b + 3 * t + k) - ak;
            v[6 + k] = __ldg(c + 3 * t + k) - ak;
        }
    } else {
        for (int k = 0; k < 3; ++k) {
            lo[k] = BIG;
            hi[k] = -BIG;
        }
        for (int k = 0; k < 9; ++k) v[k] = 0.0f;
    }
    float* rec = table + (long long)r * SLOTS;
    for (int k = 0; k < 3; ++k) {
        rec[6 * e + k] = lo[k] - widen;
        rec[6 * e + 3 + k] = hi[k] + widen;
    }
    rec[24 + e] = __ldg(metas + i);
    for (int k = 0; k < 9; ++k) rec[28 + 9 * e + k] = v[k];
}

// Plain C entry points, bound with ctypes.  Each launches on the given
// stream, does not synchronise, allocates nothing; returns
// cudaGetLastError() as an int.
extern "C" int refit_launch(
    const void* left, const void* right, const void* left_is_leaf,
    const void* right_is_leaf, const void* internal_parent, const void* leaf_parent,
    const void* sorted_tri, const void* tri_min, const void* tri_max,
    void* arrivals, void* node_min, void* node_max, int count, int cap, void* stream)
{
    if (cap <= 0 || count < 0 || count > cap) return (int)cudaErrorInvalidValue;
    const int blocks = (cap + THREADS - 1) / THREADS;
    refit_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)left, (const int*)right, (const unsigned char*)left_is_leaf,
        (const unsigned char*)right_is_leaf, (const int*)internal_parent,
        (const int*)leaf_parent, (const int*)sorted_tri, (const float*)tri_min,
        (const float*)tri_max, (unsigned int*)arrivals, (float*)node_min,
        (float*)node_max, count, cap);
    return (int)cudaGetLastError();
}

extern "C" int records_launch(
    const void* src_idx, const void* metas, const void* node_min, const void* node_max,
    const void* tri_min, const void* tri_max, const void* a, const void* b,
    const void* c, void* table, int rows, int cap, void* stream)
{
    if (rows <= 0 || cap <= 0 || rows > (1 << 28)) return (int)cudaErrorInvalidValue;
    const int blocks = (4 * rows + THREADS - 1) / THREADS;
    records_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const long long*)src_idx, (const float*)metas, (const float*)node_min,
        (const float*)node_max, (const float*)tri_min, (const float*)tri_max,
        (const float*)a, (const float*)b, (const float*)c, (float*)table, rows,
        (long long)cap);
    return (int)cudaGetLastError();
}
