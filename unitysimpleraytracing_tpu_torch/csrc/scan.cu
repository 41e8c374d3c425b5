// Exclusive prefix sum of a 1-D array, for sm_90a: out[i] = sum(x[0..i)).
//
// Replaces the TPU kernel ops/scan_pallas.py::_kernel of the JAX package.  That
// kernel is ONE launch whose grid steps run in order and hand a running carry
// from chunk to chunk in scratch memory.  Thread blocks here run in parallel
// and in no order, so the carry becomes the single-pass scan with decoupled
// look-back of Merrill and Garland ("Single-pass Parallel Prefix Scan with
// Decoupled Look-back", NVIDIA, 2016): one launch, every element read once and
// written once.
//
//   1. A block takes the next tile number from an atomic ticket (NOT from
//      blockIdx.x: blocks are not scheduled in order, and a tile that waited
//      for a predecessor that was never scheduled would never finish; every
//      ticket below one's own belongs to a block that is already running).
//   2. It loads its tile of 4096 elements (256 threads x 16 consecutive
//      elements, as 16-byte vectors where the tile is whole and aligned), sums
//      each thread's 16 serially, scans the 256 thread sums with warp shuffles
//      and publishes the tile's aggregate (tile 0: its inclusive prefix).
//   3. Its first warp looks back over the tiles before it, 32 at a time: each
//      lane waits for one predecessor's status, then the warp adds the
//      aggregates down to the nearest tile that has published its inclusive
//      prefix, and adds that prefix.  The block publishes its own inclusive
//      prefix and writes its outputs.
//
// Status words and memory order.  int32 and float32: one 64-bit word per
// tile, the tag in the high half and the value's bits in the low half, so one
// st.release.gpu publishes both.  int64: the value goes to its own slot (one
// array for aggregates, one for inclusive prefixes, so a published value is
// never overwritten), then the tag word is written with st.release.gpu; a
// reader loads the tag with ld.acquire.gpu and only then the value.  A tag is
// (epoch mod 2^30) << 2 | state (1 = aggregate, 2 = inclusive prefix), and a
// word whose epoch is not this call's reads as "not yet published", so
// nothing is cleared between calls.
//
// The control word.  One 64-bit word holds the epoch (high half) and the
// tickets drawn in this call (low half), so one atomicAdd gives a block both.
// The block that draws the last ticket moves the word to the next epoch with
// no tickets drawn; every other block has drawn its ticket, and so read the
// epoch, before that.  The state between calls lives on the device only: the
// host passes the same arguments to every call of one size, so a call can be
// captured in a CUDA graph and replayed.  The scratch belongs to one stream
// (ops/scan.py).
//
// What bounds it: bytes (8 per int32 element) at large sizes; at the sort's
// sizes (16 to 64 tiles) the launch and the look-back's dependent L2 round
// trips.  On an NVIDIA H100 80GB HBM3 at 700 W: 262,144 int32 in about
// 0.010 ms, cold L2, against a 0.00063 ms byte bound and 0.011 ms for
// torch.cumsum (chip_smoke.py; benchmarks/kernel_ab.py against the
// three-launch kernel it replaces).  Integer types are exact.  float32 is
// summed in tree order and the look-back adds predecessors in an order that
// depends on which tiles had published, so float32 results can differ from
// run to run in the last bits.

#include <cuda_runtime.h>

#define THREADS 256
#define ITEMS 16
#define TILE (THREADS * ITEMS)
#define WARPS (THREADS / 32)
#define FULL 0xffffffffu

#define ST_AGGREGATE 1u
#define ST_PREFIX 2u
#define EPOCH_MASK ((1u << 30) - 1)

typedef unsigned long long u64;

__device__ __forceinline__ void store_release(u64* p, u64 v)
{
    asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ u64 load_acquire(const u64* p)
{
    u64 v;
    asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ long long load_relaxed(const long long* p)
{
    long long v;
    asm volatile("ld.relaxed.gpu.global.s64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
    return v;
}

// Inclusive scan across the 32 lanes of a warp.
template <typename T>
__device__ __forceinline__ T warp_inclusive_scan(T v, int lane)
{
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const T up = __shfl_up_sync(FULL, v, off);
        if (lane >= off) v += up;
    }
    return v;
}

// The value of the lane below (0 for lane 0): an exclusive scan from an
// inclusive one without subtracting, so float sums keep one order.
template <typename T>
__device__ __forceinline__ T shift_up_one(T incl, int lane)
{
    const T up = __shfl_up_sync(FULL, incl, 1);
    return lane == 0 ? T(0) : up;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v)
{
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
    return v;
}

// One tile's status: publish a state with its value, read (state, value) of a
// tile of this epoch (state 0 while it has published nothing this call).
template <typename T> struct Status;

template <> struct Status<int> {
    static __device__ __forceinline__ void publish(u64* s, long long, long long tile,
                                                   unsigned tag, int v)
    {
        store_release(s + tile, ((u64)tag << 32) | (unsigned)v);
    }
    static __device__ __forceinline__ unsigned read(const u64* s, long long, long long tile,
                                                    unsigned epoch, int* v)
    {
        const u64 w = load_acquire(s + tile);
        *v = (int)(unsigned)w;
        const unsigned tag = (unsigned)(w >> 32);
        return (tag >> 2) == epoch ? (tag & 3u) : 0u;
    }
};

template <> struct Status<float> {
    static __device__ __forceinline__ void publish(u64* s, long long, long long tile,
                                                   unsigned tag, float v)
    {
        store_release(s + tile, ((u64)tag << 32) | __float_as_uint(v));
    }
    static __device__ __forceinline__ unsigned read(const u64* s, long long, long long tile,
                                                    unsigned epoch, float* v)
    {
        const u64 w = load_acquire(s + tile);
        *v = __uint_as_float((unsigned)w);
        const unsigned tag = (unsigned)(w >> 32);
        return (tag >> 2) == epoch ? (tag & 3u) : 0u;
    }
};

// int64: tags at s[0, cap), aggregates at s[cap, 2 cap), prefixes at s[2 cap, 3 cap).
template <> struct Status<long long> {
    static __device__ __forceinline__ void publish(u64* s, long long cap, long long tile,
                                                   unsigned tag, long long v)
    {
        long long* slot = (long long*)s + ((tag & 3u) == ST_AGGREGATE ? cap : 2 * cap) + tile;
        *slot = v;
        store_release(s + tile, (u64)tag << 32);
    }
    static __device__ __forceinline__ unsigned read(const u64* s, long long cap, long long tile,
                                                    unsigned epoch, long long* v)
    {
        const unsigned tag = (unsigned)(load_acquire(s + tile) >> 32);
        const unsigned state = (tag >> 2) == epoch ? (tag & 3u) : 0u;
        *v = 0;
        if (state != 0)
            *v = load_relaxed((const long long*)s + (state == ST_AGGREGATE ? cap : 2 * cap) + tile);
        return state;
    }
};

// A 16-byte vector as 16 / sizeof(T) elements and back.
template <typename T> struct Vec;

template <> struct Vec<int> {
    static constexpr int N = 4;
    static __device__ __forceinline__ void get(int4 q, int* d)
    {
        d[0] = q.x; d[1] = q.y; d[2] = q.z; d[3] = q.w;
    }
    static __device__ __forceinline__ int4 put(const int* d)
    {
        return make_int4(d[0], d[1], d[2], d[3]);
    }
};

template <> struct Vec<float> {
    static constexpr int N = 4;
    static __device__ __forceinline__ void get(int4 q, float* d)
    {
        d[0] = __int_as_float(q.x); d[1] = __int_as_float(q.y);
        d[2] = __int_as_float(q.z); d[3] = __int_as_float(q.w);
    }
    static __device__ __forceinline__ int4 put(const float* d)
    {
        return make_int4(__float_as_int(d[0]), __float_as_int(d[1]),
                         __float_as_int(d[2]), __float_as_int(d[3]));
    }
};

template <> struct Vec<long long> {
    static constexpr int N = 2;
    static __device__ __forceinline__ void get(int4 q, long long* d)
    {
        d[0] = (long long)(((u64)(unsigned)q.y << 32) | (unsigned)q.x);
        d[1] = (long long)(((u64)(unsigned)q.w << 32) | (unsigned)q.z);
    }
    static __device__ __forceinline__ int4 put(const long long* d)
    {
        return make_int4((int)d[0], (int)(d[0] >> 32), (int)d[1], (int)(d[1] >> 32));
    }
};

// 16 consecutive elements from `first`, as 16-byte vectors when all are in
// range and the address is aligned, else one by one with zeros past n.
template <typename T>
__device__ __forceinline__ void load_items(const T* __restrict__ x, long long first,
                                           long long n, T (&v)[ITEMS])
{
    const T* p = x + first;
    if (first + ITEMS <= n && ((size_t)p & 15) == 0) {
        const int4* q = reinterpret_cast<const int4*>(p);
#pragma unroll
        for (int j = 0; j < ITEMS / Vec<T>::N; ++j) Vec<T>::get(__ldg(q + j), v + j * Vec<T>::N);
    } else {
#pragma unroll
        for (int j = 0; j < ITEMS; ++j) v[j] = first + j < n ? x[first + j] : T(0);
    }
}

template <typename T>
__device__ __forceinline__ void store_items(T* __restrict__ out, long long first,
                                            long long n, const T (&v)[ITEMS])
{
    T* p = out + first;
    if (first + ITEMS <= n && ((size_t)p & 15) == 0) {
        int4* q = reinterpret_cast<int4*>(p);
#pragma unroll
        for (int j = 0; j < ITEMS / Vec<T>::N; ++j) q[j] = Vec<T>::put(v + j * Vec<T>::N);
    } else {
#pragma unroll
        for (int j = 0; j < ITEMS; ++j)
            if (first + j < n) p[j] = v[j];
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
scan_kernel(const T* __restrict__ x, T* __restrict__ out, u64* __restrict__ status,
            u64* __restrict__ control, long long n, long long cap)
{
    __shared__ long long tile_s;
    __shared__ unsigned epoch_s;
    __shared__ T warp_base[WARPS];
    __shared__ T tile_prefix;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;

    if (tid == 0) {
        const u64 c = atomicAdd(control, 1ull);
        const unsigned ticket = (unsigned)c;
        // The last ticket: the next epoch, no tickets drawn.
        if (ticket == gridDim.x - 1) atomicAdd(control, (1ull << 32) - gridDim.x);
        tile_s = ticket;
        epoch_s = (unsigned)(c >> 32) & EPOCH_MASK;
    }
    __syncthreads();
    const long long tile = tile_s;
    const unsigned epoch = epoch_s;
    const long long first = tile * TILE + (long long)tid * ITEMS;

    // This thread's 16 elements, scanned in place (exclusive); `mine` ends as
    // their sum.
    T v[ITEMS];
    load_items(x, first, n, v);
    T mine = T(0);
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
        const T e = v[j];
        v[j] = mine;
        mine += e;
    }

    const T incl = warp_inclusive_scan(mine, lane);
    const T before_me = shift_up_one(incl, lane);
    if (lane == 31) warp_base[warp] = incl;
    __syncthreads();

    if (warp == 0) {
        const T w = lane < WARPS ? warp_base[lane] : T(0);
        const T wi = warp_inclusive_scan(w, lane);
        const T we = shift_up_one(wi, lane);  // every lane: a shuffle of the whole warp
        if (lane < WARPS) warp_base[lane] = we;
        const T aggregate = __shfl_sync(FULL, wi, WARPS - 1);
        const unsigned tag = epoch << 2;
        if (tile == 0) {
            if (lane == 0) {
                Status<T>::publish(status, cap, 0, tag | ST_PREFIX, aggregate);
                tile_prefix = T(0);
            }
        } else {
            if (lane == 0) Status<T>::publish(status, cap, tile, tag | ST_AGGREGATE, aggregate);
            // Look back: lane i reads tile (top - i); tiles before 0 read as
            // prefix 0.
            T exclusive = T(0);
            long long top = tile - 1;
            while (true) {
                const long long pred = top - lane;
                T value = T(0);
                unsigned state = ST_PREFIX;
                if (pred >= 0) {
                    do {
                        state = Status<T>::read(status, cap, pred, epoch, &value);
                    } while (state == 0);
                }
                const unsigned prefixes = __ballot_sync(FULL, state == ST_PREFIX);
                if (prefixes != 0) {
                    const int nearest = __ffs(prefixes) - 1;
                    exclusive += warp_sum(lane <= nearest ? value : T(0));
                    break;
                }
                exclusive += warp_sum(value);
                top -= 32;
            }
            if (lane == 0) {
                Status<T>::publish(status, cap, tile, tag | ST_PREFIX, exclusive + aggregate);
                tile_prefix = exclusive;
            }
        }
    }
    __syncthreads();

    const T base = tile_prefix + warp_base[warp] + before_me;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) v[j] = base + v[j];
    store_items(out, first, n, v);
}

// dtype: 0 = int32, 1 = int64, 2 = float32.  `status` holds 3 * cap 64-bit
// words (cap >= the tile count) and `control` one, all zero when first used.
// Launches on the given stream, does not synchronise, allocates nothing;
// returns cudaGetLastError() as an int (-1 for an unknown dtype or a bad
// argument).
extern "C" int scan_launch(
    const void* x, void* out, void* status, void* control, long long n, long long cap,
    int dtype, void* stream)
{
    const long long tiles = (n + TILE - 1) / TILE;
    if (n <= 0 || tiles > cap) return -1;
    cudaStream_t s = (cudaStream_t)stream;
    u64* st = (u64*)status;
    u64* ctl = (u64*)control;
    switch (dtype) {
    case 0:
        scan_kernel<int><<<(unsigned)tiles, THREADS, 0, s>>>(
            (const int*)x, (int*)out, st, ctl, n, cap);
        break;
    case 1:
        scan_kernel<long long><<<(unsigned)tiles, THREADS, 0, s>>>(
            (const long long*)x, (long long*)out, st, ctl, n, cap);
        break;
    case 2:
        scan_kernel<float><<<(unsigned)tiles, THREADS, 0, s>>>(
            (const float*)x, (float*)out, st, ctl, n, cap);
        break;
    default:
        return -1;
    }
    return (int)cudaGetLastError();
}
