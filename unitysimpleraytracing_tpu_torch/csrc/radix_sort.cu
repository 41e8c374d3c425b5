// The two kernels of one stable 8-bit LSD radix-sort pass, for sm_90a.
//
// They replace the TPU kernels ops/sort_pallas.py::_hist_kernel and
// ::_rank_kernel of the JAX package.  Those get a block's histogram and its
// stable ranks from one-hot matrices and triangular-ones matrix products in
// float32; here both come from warp intrinsics in int32, which is what the
// original renderer's sort was built on (LocalRadixSort.compute, wave
// intrinsics at an assumed lane width of 32).
//
// Keys are int64 (non-negative, below 2^32; padding = 0xFFFFFFFF), 1024 keys
// per thread block, taken in index order.  `n` is a multiple of 1024: the
// wrapper pads, so every warp is full and every mask below is the full mask.
//
// Layout of the histogram and of the bases: BUCKET-MAJOR, element
// [bucket * nblocks + block] — the original's sizes[group + radix*BLOCK_SIZE]
// (LocalRadixSort.compute:132).  One flat exclusive scan of it yields, for
// every (bucket, block), the global position of that block's first key of that
// bucket; no transpose pass is needed before or after the scan.
//
// What bounds them: bytes.  K3 reads 8 bytes per key and writes 1 KB per
// block; K4 reads 8 bytes per key and 1 KB of bases per block and writes 4
// bytes per key.  The arithmetic is a shift, a mask and a few integer adds per
// key.

#include <cuda_runtime.h>

#define BLOCK_KEYS 1024
#define THREADS 256
#define BUCKETS 256
#define WARPS (THREADS / 32)
#define ROUNDS (BLOCK_KEYS / THREADS)
#define FULL_MASK 0xffffffffu

__device__ __forceinline__ int digit_of(long long key, int shift)
{
    return (int)((key >> shift) & (BUCKETS - 1));
}

// K3.  Per block, the 256-bucket histogram of digit (key >> shift) & 255.
// Lanes with the same digit find each other with __match_any_sync and their
// lowest lane adds the group's size once, so a block whose keys share one
// digit (the top pass of Morton codes) does 32 shared-memory atomics instead
// of 1024 on one address.
__global__ void __launch_bounds__(THREADS)
digit_histogram_kernel(const long long* __restrict__ keys, int* __restrict__ hist_t,
                       int nblocks, int shift)
{
    __shared__ int hist[BUCKETS];
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    hist[tid] = 0;
    __syncthreads();
    const long long* block_keys = keys + (long long)blockIdx.x * BLOCK_KEYS;
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
        const int d = digit_of(block_keys[r * THREADS + tid], shift);
        const unsigned peers = __match_any_sync(FULL_MASK, d);
        if (lane == __ffs(peers) - 1) atomicAdd(&hist[d], __popc(peers));
    }
    __syncthreads();
    hist_t[(long long)tid * nblocks + blockIdx.x] = hist[tid];
}

// K4.  Destination of every key for one stable pass:
//   dst = bases[digit * nblocks + block] + (# earlier keys of that digit in the block).
// Atomic ranks would not be stable, so the rank comes from position alone:
// warp w owns keys [128 w, 128 w + 128) of the block and walks them in four
// rounds of 32 consecutive keys.  In a round, __match_any_sync gives each lane
// the lanes holding its digit; the ones below it are its rank in the round,
// and counts[w][digit] holds what earlier rounds of this warp saw.  After the
// sweep one thread per digit turns the eight per-warp totals into exclusive
// offsets on top of the block's global base.
__global__ void __launch_bounds__(THREADS)
digit_rank_kernel(const long long* __restrict__ keys, const int* __restrict__ bases,
                  int* __restrict__ dst, int nblocks, int shift)
{
    __shared__ int counts[WARPS][BUCKETS];
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) counts[w][tid] = 0;
    __syncthreads();

    const long long first =
        (long long)blockIdx.x * BLOCK_KEYS + warp * (ROUNDS * 32) + lane;
    const unsigned lanes_below = (1u << lane) - 1u;
    int digit[ROUNDS];
    int rank[ROUNDS];
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
        const int d = digit_of(keys[first + r * 32], shift);
        const unsigned peers = __match_any_sync(FULL_MASK, d);
        const int seen = counts[warp][d];
        digit[r] = d;
        rank[r] = seen + __popc(peers & lanes_below);
        __syncwarp();
        if (lane == __ffs(peers) - 1) counts[warp][d] = seen + __popc(peers);
        __syncwarp();
    }
    __syncthreads();

    // Thread tid serves digit tid: counts[w][tid] becomes the destination of
    // warp w's first key of that digit.
    int running = bases[(long long)tid * nblocks + blockIdx.x];
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
        const int c = counts[w][tid];
        counts[w][tid] = running;
        running += c;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < ROUNDS; ++r)
        dst[first + r * 32] = counts[warp][digit[r]] + rank[r];
}

// Both entry points launch on the given stream, do not synchronise, allocate
// nothing, and return cudaGetLastError() as an int.

extern "C" int digit_histogram_launch(
    const void* keys, void* hist_t, int nblocks, int shift, void* stream)
{
    digit_histogram_kernel<<<nblocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const long long*)keys, (int*)hist_t, nblocks, shift);
    return (int)cudaGetLastError();
}

extern "C" int digit_rank_launch(
    const void* keys, const void* bases, void* dst, int nblocks, int shift, void* stream)
{
    digit_rank_kernel<<<nblocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const long long*)keys, (const int*)bases, (int*)dst, nblocks, shift);
    return (int)cudaGetLastError();
}
