// Exclusive prefix sum of a 1-D array, for sm_90a: out[i] = sum(x[0..i)).
//
// Replaces the TPU kernel ops/scan_pallas.py::_kernel of the JAX package.  That
// kernel is ONE launch whose grid steps run in order and hand a running carry
// from chunk to chunk in scratch memory.  Thread blocks here run in parallel
// and in no order, so nothing can be carried between them; the scan takes the
// original renderer's three-stage form instead (Scan.compute:15-96, PreScan ->
// BlockSum -> GlobalScan):
//
//   1. scan_chunks_kernel: every block scans its own 1024-element chunk and
//      writes the chunk's total;
//   2. the totals are scanned by the same kernel (the wrapper recurses while
//      more than one chunk of totals is left);
//   3. add_bases_kernel: every chunk adds its scanned base.
//
// Inside a chunk: each of the 256 threads owns 4 consecutive elements and sums
// them serially, the 32 thread sums of a warp are scanned with __shfl_up_sync
// (five shuffle steps), the 8 warp sums by the first warp the same way.
//
// What bounds it: bytes.  One add per element against 8 bytes moved (element
// in, element out); stages 2 and 3 add one more read and write of the output.
// Integer types are exact.  float32 is summed in the tree order above, which
// is neither the left-to-right order of a serial loop nor torch.cumsum's.

#include <cuda_runtime.h>

#define CHUNK 1024
#define THREADS 256
#define ITEMS 4
#define WARPS (THREADS / 32)

// Inclusive scan across the 32 lanes of a warp.
template <typename T>
__device__ __forceinline__ T warp_inclusive_scan(T v, int lane)
{
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const T up = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += up;
    }
    return v;
}

// The value of the lane below (0 for lane 0): an exclusive scan from an
// inclusive one without subtracting, so float sums keep one order.
template <typename T>
__device__ __forceinline__ T shift_up_one(T incl, int lane)
{
    const T up = __shfl_up_sync(0xffffffffu, incl, 1);
    return lane == 0 ? T(0) : up;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
scan_chunks_kernel(const T* __restrict__ x, T* __restrict__ out,
                   T* __restrict__ totals, long long n)
{
    __shared__ T warp_base[WARPS];
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const long long first = (long long)blockIdx.x * CHUNK + (long long)tid * ITEMS;

    // Exclusive prefix of this thread's own elements; `mine` ends as their sum.
    T prefix[ITEMS];
    T mine = T(0);
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
        const long long i = first + j;
        const T v = i < n ? x[i] : T(0);
        prefix[j] = mine;
        mine += v;
    }

    const T incl = warp_inclusive_scan(mine, lane);
    const T before_me = shift_up_one(incl, lane);
    if (lane == 31) warp_base[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        const T w = lane < WARPS ? warp_base[lane] : T(0);
        const T wi = warp_inclusive_scan(w, lane);
        const T we = shift_up_one(wi, lane);
        if (lane < WARPS) warp_base[lane] = we;
        if (lane == WARPS - 1 && totals != nullptr) totals[blockIdx.x] = wi;
    }
    __syncthreads();

    const T base = warp_base[warp] + before_me;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
        const long long i = first + j;
        if (i < n) out[i] = base + prefix[j];
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
add_bases_kernel(T* __restrict__ out, const T* __restrict__ bases, long long n)
{
    const T base = bases[blockIdx.x];
    const long long first = (long long)blockIdx.x * CHUNK + (long long)threadIdx.x * ITEMS;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
        const long long i = first + j;
        if (i < n) out[i] += base;
    }
}

static inline unsigned chunks_of(long long n)
{
    return (unsigned)((n + CHUNK - 1) / CHUNK);
}

// dtype: 0 = int32, 1 = int64, 2 = float32.  Both entry points launch on the
// given stream, do not synchronise, allocate nothing, and return
// cudaGetLastError() as an int (-1 for an unknown dtype).

// Stage 1 (and 2): chunk-local exclusive scan of x[0..n) into out; `totals`
// (one element per chunk) may be null when there is a single chunk.
extern "C" int scan_chunks_launch(
    const void* x, void* out, void* totals, long long n, int dtype, void* stream)
{
    const unsigned blocks = chunks_of(n);
    cudaStream_t s = (cudaStream_t)stream;
    switch (dtype) {
    case 0:
        scan_chunks_kernel<int><<<blocks, THREADS, 0, s>>>(
            (const int*)x, (int*)out, (int*)totals, n);
        break;
    case 1:
        scan_chunks_kernel<long long><<<blocks, THREADS, 0, s>>>(
            (const long long*)x, (long long*)out, (long long*)totals, n);
        break;
    case 2:
        scan_chunks_kernel<float><<<blocks, THREADS, 0, s>>>(
            (const float*)x, (float*)out, (float*)totals, n);
        break;
    default:
        return -1;
    }
    return (int)cudaGetLastError();
}

// Stage 3: out[i] += bases[i / 1024].
extern "C" int scan_add_bases_launch(
    void* out, const void* bases, long long n, int dtype, void* stream)
{
    const unsigned blocks = chunks_of(n);
    cudaStream_t s = (cudaStream_t)stream;
    switch (dtype) {
    case 0:
        add_bases_kernel<int><<<blocks, THREADS, 0, s>>>((int*)out, (const int*)bases, n);
        break;
    case 1:
        add_bases_kernel<long long><<<blocks, THREADS, 0, s>>>(
            (long long*)out, (const long long*)bases, n);
        break;
    case 2:
        add_bases_kernel<float><<<blocks, THREADS, 0, s>>>(
            (float*)out, (const float*)bases, n);
        break;
    default:
        return -1;
    }
    return (int)cudaGetLastError();
}
