// Primitive-cost probes for sm_90a: what one dependent step of a traversal
// loop costs on this card.
//
// Replaces the two TPU kernels of the JAX package's benchmarks/kernel_probe.py:
// the kernel of run_probe (P1: an N-iteration serial loop around one primitive
// on a (4096, 16) float32 table) and the kernel of run_dma_probe (P2: rounds of
// `depth` asynchronous row copies whose indices come from an LCG chain seeded
// by data fetched in the round before).  Both compute what the TPU kernels
// compute — the same loops, row sequences, variants and one float32 out — in
// this card's terms:
//
//   P1  one block.  The TPU's (8, 128) vector carry is one lane per thread of
//       a 1024-thread block; its jnp.sum is a block reduction (warp shuffles,
//       one shared-memory step, a second shuffle pass); the scalar carry is
//       kept uniformly by every thread; the 256 KB table is read from global
//       memory through the read-only path (L1/L2 resident).  The wrapper
//       gives the variants that touch the vector carry 1024 threads and the
//       scalar ones a single warp: 32 warps stepping one scalar chain share
//       four warp schedulers, and the loop then times them, not the
//       dependent operation (on an H100 80GB HBM3 at 700 W `fetch_x32` took
//       302 ns an iteration at 1024 threads and 204 at 32, `dep_fetch_l1_x1`
//       57.9 and 40.5).  Variants that
//       exist only here read the cost of what the traversal kernels do per
//       pop: a fetch whose row depends on the data just fetched (through L1,
//       or past L1 with ld.global.cg), the same from shared memory, and a
//       data-dependent read of a per-thread 64-entry local-memory stack.
//   P2  one warp.  A 512-byte row is 32 lanes x one 16-byte cp.async into a
//       `depth`-slot shared-memory buffer, one commit group per row, and
//       cp.async.wait_group before each slot is accumulated.
//
// What bounds them: neither bytes nor operations.  Each probe is a serial
// chain by definition — iteration i+1 cannot start before iteration i's
// result — so its least time is iterations x the latency of the dependent
// operation.  That latency is what the probe is for.
//
// Arithmetic contract: compiled with -fmad=false and without fast-math, every
// product and sum is a separate IEEE float32 operation in the order written;
// the plain PyTorch versions (benchmarks/kernel_probe.py) repeat them, and the
// tables hold small integers, so kernel and plain version agree bit for bit.

#include <cuda_runtime.h>

#define P1_THREADS 1024
#define P1_WARPS (P1_THREADS / 32)
#define TAB_ROWS 4096
#define TAB_COLS 16
#define SMEM_ROWS 2048
#define STACK_DEPTH 64
#define ROW_FLOATS 128  // one 512-byte row of the P2 table

enum Variant {
    V_EMPTY = 0,        // s += 1
    V_FETCH = 1,        // K fetches from row (i*37+11) & 4095, columns c % 16
    V_REDUCE1 = 2,      // s += sum(v + 1)
    V_REDUCE2 = 3,      // s = s + sum(v + 1) + sum(v + 2)
    V_VEC40 = 4,        // 10 x (x*1.0001+0.5, min 3, max -3, -0.1) on v
    V_SWITCH8 = 5,      // 8-way branch on r & 7 picks two columns of row r / 8
    V_DEP_L1 = 6,       // row depends on the value just fetched; __ldg
    V_DEP_L2 = 7,       // the same past L1 (__ldcg)
    V_DEP_ROW64_L1 = 8, // four 16-byte loads of one 64-byte row, dependent; __ldg
    V_DEP_ROW64_L2 = 9, // the same past L1
    V_DEP_SMEM = 10,    // dependent fetch from a 2048-row shared-memory copy
    V_DEP_STACK = 11,   // write + data-dependent read of a local 64-entry stack
};

// Sum over the lanes of a 1024-thread block; every thread gets the total.
__device__ __forceinline__ float block_sum(float x, float* warp_part)
{
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    if (lane == 0) warp_part[warp] = x;
    __syncthreads();
    float t = warp_part[lane];  // P1_WARPS == 32: one partial per lane
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
    __syncthreads();  // warp_part is free again
    return t;
}

template <int VARIANT, int K>
__global__ void __launch_bounds__(P1_THREADS)
probe_kernel(const float* __restrict__ tab, float* __restrict__ out, int n_iters)
{
    __shared__ float warp_part[P1_WARPS];
    extern __shared__ __align__(16) float smem_tab[];  // V_DEP_SMEM only

    float s = 0.0f;   // the scalar carry, uniform over the block
    float v = 0.0f;   // this thread's lane of the (8, 128) vector carry
    int chase = 0;    // the data-dependent row of the V_DEP_* variants
    float stack[STACK_DEPTH];

    if (VARIANT == V_DEP_SMEM) {
        for (int j = threadIdx.x; j < SMEM_ROWS * TAB_COLS; j += blockDim.x) smem_tab[j] = tab[j];
        __syncthreads();
    }
    if (VARIANT == V_DEP_STACK) {
#pragma unroll 1
        for (int j = 0; j < STACK_DEPTH; ++j) stack[j] = 0.0f;
    }

#pragma unroll 1
    for (int i = 0; i < n_iters; ++i) {
        if (VARIANT == V_EMPTY) {
            s = s + 1.0f;
        } else if (VARIANT == V_FETCH) {
            const int r = (i * 37 + 11) & (TAB_ROWS - 1);
            float acc = s;
#pragma unroll
            for (int c = 0; c < K; ++c) acc = acc + __ldg(tab + r * TAB_COLS + (c % TAB_COLS));
            s = acc;
        } else if (VARIANT == V_REDUCE1) {
            s = s + block_sum(v + 1.0f, warp_part);
        } else if (VARIANT == V_REDUCE2) {
            const float a = block_sum(v + 1.0f, warp_part);
            const float b = block_sum(v + 2.0f, warp_part);
            s = s + a + b;
        } else if (VARIANT == V_VEC40) {
            float x = v;
#pragma unroll
            for (int j = 0; j < 10; ++j) {
                x = x * 1.0001f + 0.5f;
                x = fminf(x, 3.0f);
                x = fmaxf(x, -3.0f);
                x = x - 0.1f;
            }
            v = x;
        } else if (VARIANT == V_SWITCH8) {
            const int r = (i * 37 + 11) & (TAB_ROWS * 8 - 1);
            const float* row = tab + (r >> 3) * TAB_COLS;
            float a, b;
            switch (r & 7) {
            case 0: a = __ldg(row + 0); b = __ldg(row + 1); break;
            case 1: a = __ldg(row + 2); b = __ldg(row + 3); break;
            case 2: a = __ldg(row + 4); b = __ldg(row + 5); break;
            case 3: a = __ldg(row + 6); b = __ldg(row + 7); break;
            case 4: a = __ldg(row + 8); b = __ldg(row + 9); break;
            case 5: a = __ldg(row + 10); b = __ldg(row + 11); break;
            case 6: a = __ldg(row + 12); b = __ldg(row + 13); break;
            default: a = __ldg(row + 14); b = __ldg(row + 15); break;
            }
            s = s + a + b;
        } else if (VARIANT == V_DEP_L1 || VARIANT == V_DEP_L2 || VARIANT == V_DEP_SMEM) {
            float val;
            if (VARIANT == V_DEP_L1) val = __ldg(tab + chase * TAB_COLS);
            else if (VARIANT == V_DEP_L2) val = __ldcg(tab + chase * TAB_COLS);
            else val = smem_tab[chase * TAB_COLS];
            s = s + val;
            const int mask = (VARIANT == V_DEP_SMEM ? SMEM_ROWS : TAB_ROWS) - 1;
            chase = (chase * 37 + 11 + (int)val) & mask;
        } else if (VARIANT == V_DEP_ROW64_L1 || VARIANT == V_DEP_ROW64_L2) {
            const float4* row = reinterpret_cast<const float4*>(tab + chase * TAB_COLS);
            float4 q[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
                q[j] = VARIANT == V_DEP_ROW64_L1 ? __ldg(row + j) : __ldcg(row + j);
            const float val = q[0].x + q[1].y + q[2].z + q[3].w;
            s = s + val;
            chase = (chase * 37 + 11 + (int)val) & (TAB_ROWS - 1);
        } else if (VARIANT == V_DEP_STACK) {
            const int w = (i * 37 + 11) & (STACK_DEPTH - 1);
            stack[w] = (float)(i & 7);
            const int rd = ((int)s + w * 5 + 3) & (STACK_DEPTH - 1);
            s = s + stack[rd];
        }
    }
    // out = acc_s + acc_v[0, 0], as the TPU kernel writes it.
    if (threadIdx.x == 0) out[0] = s + v;
}

template <int VARIANT, int K>
static int launch_p1(const float* tab, float* out, int n_iters, int threads, cudaStream_t s)
{
    // The block reduction assumes one partial per lane: exactly 32 warps.
    const bool reduces = VARIANT == V_REDUCE1 || VARIANT == V_REDUCE2;
    if (threads != P1_THREADS && (reduces || threads != 32)) return -1;
    size_t dyn = 0;
    if (VARIANT == V_DEP_SMEM) {
        dyn = (size_t)SMEM_ROWS * TAB_COLS * sizeof(float);
        cudaError_t e = cudaFuncSetAttribute(
            probe_kernel<VARIANT, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
        if (e != cudaSuccess) return (int)e;
    }
    probe_kernel<VARIANT, K><<<1, threads, dyn, s>>>(tab, out, n_iters);
    return (int)cudaGetLastError();
}

// P1.  Launches on the given stream, does not synchronise, allocates nothing;
// returns cudaGetLastError() as an int, or -1 for an unknown variant.  `tab`
// is the (4096, 16) float32 table, `out` one float32; `k` is the fetch count
// of V_FETCH (1, 4, 8, 16 or 32) and ignored otherwise; `threads` is the
// block size, 1024 or (not for the reductions) 32.
extern "C" int kernel_probe_p1_launch(
    const void* tab, void* out, int variant, int k, int n_iters, int threads, void* stream)
{
    const float* t = (const float*)tab;
    float* o = (float*)out;
    cudaStream_t s = (cudaStream_t)stream;
    switch (variant) {
    case V_EMPTY: return launch_p1<V_EMPTY, 0>(t, o, n_iters, threads, s);
    case V_FETCH:
        switch (k) {
        case 1: return launch_p1<V_FETCH, 1>(t, o, n_iters, threads, s);
        case 4: return launch_p1<V_FETCH, 4>(t, o, n_iters, threads, s);
        case 8: return launch_p1<V_FETCH, 8>(t, o, n_iters, threads, s);
        case 16: return launch_p1<V_FETCH, 16>(t, o, n_iters, threads, s);
        case 32: return launch_p1<V_FETCH, 32>(t, o, n_iters, threads, s);
        default: return -1;
        }
    case V_REDUCE1: return launch_p1<V_REDUCE1, 0>(t, o, n_iters, threads, s);
    case V_REDUCE2: return launch_p1<V_REDUCE2, 0>(t, o, n_iters, threads, s);
    case V_VEC40: return launch_p1<V_VEC40, 0>(t, o, n_iters, threads, s);
    case V_SWITCH8: return launch_p1<V_SWITCH8, 0>(t, o, n_iters, threads, s);
    case V_DEP_L1: return launch_p1<V_DEP_L1, 0>(t, o, n_iters, threads, s);
    case V_DEP_L2: return launch_p1<V_DEP_L2, 0>(t, o, n_iters, threads, s);
    case V_DEP_ROW64_L1: return launch_p1<V_DEP_ROW64_L1, 0>(t, o, n_iters, threads, s);
    case V_DEP_ROW64_L2: return launch_p1<V_DEP_ROW64_L2, 0>(t, o, n_iters, threads, s);
    case V_DEP_SMEM: return launch_p1<V_DEP_SMEM, 0>(t, o, n_iters, threads, s);
    case V_DEP_STACK: return launch_p1<V_DEP_STACK, 0>(t, o, n_iters, threads, s);
    default: return -1;
    }
}

// ---- P2 --------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* smem_dst, const float* gmem_src)
{
    const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src) : "memory");
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's commit groups are in flight.
// The count is an immediate of the instruction; the callers' loops are
// unrolled, so the switch folds to one case.
__device__ __forceinline__ void cp_async_wait(int pending)
{
    switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
    }
}

template <int DEPTH, int RPR>
__global__ void __launch_bounds__(32)
dma_probe_kernel(const float* __restrict__ table, float* __restrict__ out,
                 int rounds, unsigned row_mask)
{
    __shared__ __align__(16) float scratch[DEPTH * RPR * ROW_FLOATS];
    const int lane = threadIdx.x;
    unsigned base = 1u;
    float acc = 0.0f;

#pragma unroll 1
    for (int r = 0; r < rounds; ++r) {
        // This round's rows: an LCG chain seeded by `base`, which depends on
        // the data the round before fetched (a traversal's stack dependence).
        unsigned idx[DEPTH];
        unsigned x = base;
#pragma unroll
        for (int j = 0; j < DEPTH; ++j) {
            x = (x * 1103515245u + 12345u) & row_mask;
            idx[j] = x;
        }
        // All copies of the round go out back to back, one group per row.
#pragma unroll
        for (int j = 0; j < DEPTH; ++j) {
            const float* src = table + (size_t)idx[j] * (RPR * ROW_FLOATS);
            float* dst = scratch + j * (RPR * ROW_FLOATS);
#pragma unroll
            for (int q = 0; q < RPR; ++q)
                cp_async16(dst + q * ROW_FLOATS + lane * 4, src + q * ROW_FLOATS + lane * 4);
            cp_async_commit();
        }
        // Drain in order; a lane sees its neighbours' bytes after the warp
        // has met behind the wait.
#pragma unroll
        for (int j = 0; j < DEPTH; ++j) {
            cp_async_wait(DEPTH - 1 - j);
            __syncwarp();
            acc = acc + scratch[j * (RPR * ROW_FLOATS)];
        }
        // Data dependence into the next round's indices.
        base = idx[DEPTH - 1] ^ (unsigned)(int)scratch[1];
        __syncwarp();  // every lane has read before the next round overwrites
    }
    if (lane == 0) out[0] = acc;
}

template <int DEPTH, int RPR>
static int launch_p2(const float* table, float* out, int rounds, unsigned row_mask, cudaStream_t s)
{
    dma_probe_kernel<DEPTH, RPR><<<1, 32, 0, s>>>(table, out, rounds, row_mask);
    return (int)cudaGetLastError();
}

// P2.  `table` is ((row_mask + 1) * rows_per_rec, 128) float32, 16-byte
// aligned; row_mask + 1 is a power of two.  depth in {1, 2, 4, 8},
// rows_per_rec in {1, 4}; -1 for anything else.  Same launch contract as P1.
extern "C" int kernel_probe_p2_launch(
    const void* table, void* out, int depth, int rows_per_rec, int rounds,
    unsigned row_mask, void* stream)
{
    const float* t = (const float*)table;
    float* o = (float*)out;
    cudaStream_t s = (cudaStream_t)stream;
    if (rows_per_rec == 1) {
        switch (depth) {
        case 1: return launch_p2<1, 1>(t, o, rounds, row_mask, s);
        case 2: return launch_p2<2, 1>(t, o, rounds, row_mask, s);
        case 4: return launch_p2<4, 1>(t, o, rounds, row_mask, s);
        case 8: return launch_p2<8, 1>(t, o, rounds, row_mask, s);
        default: return -1;
        }
    }
    if (rows_per_rec == 4) {
        switch (depth) {
        case 1: return launch_p2<1, 4>(t, o, rounds, row_mask, s);
        case 2: return launch_p2<2, 4>(t, o, rounds, row_mask, s);
        case 4: return launch_p2<4, 4>(t, o, rounds, row_mask, s);
        case 8: return launch_p2<8, 4>(t, o, rounds, row_mask, s);
        default: return -1;
        }
    }
    return -1;
}
