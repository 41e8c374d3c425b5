// The stable 8-bit LSD radix sort of the "cuda" engine, for sm_90a: one launch
// that counts all four digits of every key, then one launch per digit pass that
// ranks the keys, finds each digit's offset by decoupled look-back and moves
// keys and values into place.  The design is Onesweep (Adinets and Merrill,
// "Onesweep: A Faster Least Significant Digit Radix Sort for GPUs", 2022).
//
// K3, the count (digit_count_kernel).  Replaces the TPU kernel
// ops/sort_pallas.py::_hist_kernel of the JAX package, which histograms one
// digit per 1024-key block with one-hot matrices.  A permutation does not
// change how many keys hold each digit, so the four passes' digit totals are
// counted once, from the unsorted keys: one launch reads each key once
// (16-byte loads, 16 keys a thread) and adds each of its four digits to a
// shared-memory histogram; a warp whose 32 digits are equal (the top pass of
// Morton codes, padding) adds 32 from one lane instead of 32 atomics on one
// address (a vote; grouping lanes with __match_any_sync instead took 2.5x
// as long, PERF.md); each block adds its 4 x 256 counts to running totals with
// atomicAdd, and the block that draws the last ticket copies the totals out
// and zeroes them for the next call.  The exclusive scan of those 1024
// counts (K5, csrc/scan.cu) gives every pass's digit bases.  The same body,
// instantiated for one digit, is digit_histogram: the per-1024-key-block
// histogram of one shift, bucket-major (hist_t[bucket * nblocks + block]),
// staged in shared memory for four blocks and written as 16-byte runs.
//
// K4, the pass (digit_pass_kernel).  Replaces the TPU kernel
// ops/sort_pallas.py::_rank_kernel, which gives each key its destination
// (bucket base + stable rank in its block) by triangular-ones matrix products,
// after which the JAX package moves the keys with an XLA scatter.  Here one
// launch per pass does the rank and the move:
//
//   1. A thread block takes the next tile number from an atomic ticket, not
//      from blockIdx.x (scan.cu: every ticket below one's own belongs to a
//      block that is already running, so a look-back never waits on a block
//      that was not scheduled).
//   2. It loads its tile (256 threads x ITEMS keys and values).  Warp w ranks
//      keys [w * 32 * ITEMS, (w + 1) * 32 * ITEMS) of the tile in rounds of 32
//      consecutive keys: nine ballots (one per bit of the digit) give each
//      lane the lanes holding its digit (what __match_any_sync gives, faster
//      here), the ones below it are its rank in the round, and
//      counts[w][digit] holds what earlier rounds of this warp saw.  The rank
//      comes from position alone, so the pass is stable.
//   3. Thread d (one per digit) turns the eight per-warp counts into offsets,
//      publishes the tile's count of digit d in a status word, and looks back
//      over the earlier tiles' words of digit d, LOOKBACK words at a time,
//      adding their counts down to the nearest tile that has published its
//      inclusive prefix; then it publishes its own.  Key i of digit d goes to
//        digit base of d + earlier tiles' keys of d + keys of d before it in the tile.
//   4. The block stages its keys in shared memory in destination order (the
//      tile sorted by digit, stable) and writes each digit's run as
//      consecutive addresses; then the values the same way.  The original
//      renderer sorts each block locally for the same reason
//      (GlobalRadixSort.compute:35-39).
//
// dst (the destination of every key), hist_t (per-1024-key-block digit
// histogram, bucket-major) and scanned (the flat exclusive scan of hist_t,
// i.e. for each (bucket, block) the position of the block's first key of that
// bucket) are written only when the caller passes them: they are the per-pass
// observables of the validators, defined on 1024-key blocks whatever the tile.
// The same body, instantiated without the look-back and the move, is
// digit_rank: given bucket-major per-block bases, the destination of every key.
//
// Status words and memory order: one 64-bit word per (tile, digit), the tag
// in the high half ((epoch mod 2^30) << 2 | state, state 1 = the tile's count,
// 2 = the inclusive prefix) and the count in the low half, as in scan.cu's
// int32 words; a word of another epoch reads as "not yet published", so
// nothing is cleared between calls.  scan.cu publishes with st.release.gpu
// and reads with ld.acquire.gpu; here the count travels in the word itself,
// so both are relaxed (st.relaxed.gpu, ld.relaxed.gpu): the release fences
// cost 6-8 % of a sort and acquire loads of a look-back window do not
// overlap (PERF.md).
// One control word holds the epoch (high half) and the tickets drawn (low
// half); the block that draws the last ticket moves it to the next epoch.  The
// count's running totals and its ticket are zero between calls: the last block
// leaves them so.  The scratch belongs to one stream (ops/sort_radix_cuda.py).
//
// Keys are int64, non-negative and below 2^32 (padding keys 0xFFFFFFFF); values
// are any 32-bit type, moved as bits.  n < 2^31.
//
// What bounds it: bytes, by count.  The count reads 8 bytes a key; a pass
// reads 12 and writes 12 bytes a key, plus 2 KB of status words written and at
// least 2 KB read per tile; the arithmetic is a few dozen integer operations
// a key.  On the card the kernels run at several times that bound: at 1 M
// keys the 256 tiles of a pass are resident at once (two 256-thread blocks a
// SM), so a pass lasts about one block's life, its loads, sixteen ranking
// rounds, look-back and staged stores in sequence; tiles of 4096 keys (not
// 1024 or 2048) keep the look-back short and each digit's run long.

#include <cuda_runtime.h>

#define THREADS 256
#define WARPS (THREADS / 32)
#define BUCKETS 256
#define BLOCK_KEYS 1024
#define PASSES 4
#define FULL 0xffffffffu
#define NO_DIGIT BUCKETS  // the "digit" of a lane past n: matches no real digit

// The count: 16 keys a thread, as eight 16-byte vectors of two keys.
#define COUNT_ITEMS 16
#define COUNT_CHUNK (THREADS * COUNT_ITEMS)
#define COUNT_ROWS (COUNT_CHUNK / BLOCK_KEYS)  // 1024-key blocks a count block sees

// The pass: keys a thread moves (a tile is THREADS * PASS_ITEMS keys), and
// the predecessors a look-back step reads at once.
#define PASS_ITEMS 16
#define LOOKBACK 4

#define ST_AGGREGATE 1u
#define ST_PREFIX 2u
#define EPOCH_MASK ((1u << 30) - 1)

typedef unsigned long long u64;

static_assert(COUNT_ROWS == PASSES, "a count block stages one histogram row per pass");

// A status word holds its tile's count in the same 64 bits as its tag, so one
// relaxed access (coherent at gpu scope) writes or reads a consistent pair,
// and no other data hangs on it: neither a release fence before the store
// nor acquire order on the loads is needed.  Relaxed loads of a look-back
// window are not ordered among themselves and overlap.
__device__ __forceinline__ void store_relaxed(u64* p, u64 v)
{
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ u64 load_relaxed(const u64* p)
{
    u64 v;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
    return v;
}

// The state of a status word of this epoch (0 = not yet published).
__device__ __forceinline__ unsigned state_of(u64 w, unsigned epoch)
{
    const unsigned tag = (unsigned)(w >> 32);
    return (tag >> 2) == epoch ? (tag & 3u) : 0u;
}

__device__ __forceinline__ int digit_of(long long key, int shift)
{
    return (int)((key >> shift) & (BUCKETS - 1));
}

// Inclusive scan across the 32 lanes of a warp.
__device__ __forceinline__ int warp_inclusive_scan(int v, int lane)
{
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const int up = __shfl_up_sync(FULL, v, off);
        if (lane >= off) v += up;
    }
    return v;
}

// The lanes of the warp that hold the same digit as this lane, from one
// ballot per bit of the digit (nine bits: NO_DIGIT, 256, matches no real
// digit).  __match_any_sync gives the same mask; on this card it took longer.
__device__ __forceinline__ unsigned peers_of(int d)
{
    unsigned peers = FULL;
#pragma unroll
    for (int b = 0; b < 9; ++b) {
        const bool bit = (d >> b) & 1;
        const unsigned m = __ballot_sync(FULL, bit);
        peers &= bit ? m : ~m;
    }
    return peers;
}

// Add one key's digit to a shared-memory histogram row.  A warp whose 32
// keys share one digit (the top pass of Morton codes, padding) adds 32 once;
// otherwise each lane adds its own 1.
__device__ __forceinline__ void count_digit(int* row, int d, int lane)
{
    const int d0 = __shfl_sync(FULL, d, 0);
    if (__all_sync(FULL, d == d0)) {
        if (lane == 0 && d != NO_DIGIT) atomicAdd(row + d, 32);
    } else if (d != NO_DIGIT) {
        atomicAdd(row + d, 1);
    }
}

// K3.  ALL_DIGITS: the four passes' digit counts of keys[0, n) into out[p * 256
// + d] (accum and ticket: running totals and the blocks done, zero between
// calls).  Otherwise: the histogram of digit (key >> shift) & 255 of every
// 1024-key block into out[d * nblocks + block] (n a multiple of 1024).
// Thread t reads keys [chunk + 512 j + 2 t, +2) for j = 0..7, so vector j lies
// in the chunk's 1024-key block j / 2.
template <bool ALL_DIGITS>
__global__ void __launch_bounds__(THREADS)
digit_count_kernel(const long long* __restrict__ keys, int* __restrict__ out,
                   unsigned* __restrict__ accum, unsigned* __restrict__ ticket,
                   int n, int nblocks, int shift)
{
    __shared__ int hist[COUNT_ROWS][BUCKETS];
    __shared__ bool last_s;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
#pragma unroll
    for (int q = 0; q < COUNT_ROWS; ++q) hist[q][tid] = 0;
    __syncthreads();

    const long long chunk = (long long)blockIdx.x * COUNT_CHUNK;
    const long long* p = keys + chunk + 2 * tid;
    long long k[COUNT_ITEMS];
    const bool whole = chunk + COUNT_CHUNK <= n && ((size_t)p & 15) == 0;
    if (whole) {
#pragma unroll
        for (int j = 0; j < COUNT_ITEMS / 2; ++j) {
            const longlong2 v = __ldg(reinterpret_cast<const longlong2*>(p + j * 2 * THREADS));
            k[2 * j] = v.x;
            k[2 * j + 1] = v.y;
        }
    } else {
#pragma unroll
        for (int j = 0; j < COUNT_ITEMS; ++j) {
            const long long i = chunk + (j >> 1) * 2 * THREADS + 2 * tid + (j & 1);
            k[j] = i < n ? keys[i] : -1;
        }
    }
#pragma unroll
    for (int j = 0; j < COUNT_ITEMS; ++j) {
        const long long i = chunk + (j >> 1) * 2 * THREADS + 2 * tid + (j & 1);
        const bool valid = whole || i < n;
        if (ALL_DIGITS) {
#pragma unroll
            for (int q = 0; q < PASSES; ++q)
                count_digit(hist[q], valid ? digit_of(k[j], 8 * q) : NO_DIGIT, lane);
        } else {
            count_digit(hist[j >> 2], valid ? digit_of(k[j], shift) : NO_DIGIT, lane);
        }
    }
    __syncthreads();

    if (!ALL_DIGITS) {
        // Thread t writes bucket t of the chunk's (up to) four blocks: one run
        // of consecutive ints instead of four writes a stride apart.
        const long long b0 = (long long)blockIdx.x * COUNT_ROWS;
        int* row = out + (long long)tid * nblocks + b0;
#pragma unroll
        for (int q = 0; q < COUNT_ROWS; ++q)
            if (b0 + q < nblocks) row[q] = hist[q][tid];
        return;
    }

#pragma unroll
    for (int q = 0; q < PASSES; ++q) {
        const int c = hist[q][tid];
        if (c != 0) atomicAdd(accum + q * BUCKETS + tid, (unsigned)c);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) last_s = atomicAdd(ticket, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!last_s) return;
    // Every other block has added its counts and fenced before drawing its
    // ticket: read the totals and leave zeros for the next call.
    __threadfence();
#pragma unroll
    for (int q = 0; q < PASSES; ++q)
        out[q * BUCKETS + tid] = (int)atomicExch(accum + q * BUCKETS + tid, 0u);
    if (tid == 0) atomicExch(ticket, 0u);
}

// K4.  ONESWEEP: one digit pass (ticketed tiles, look-back, move); `bases` is
// the flat exclusive scan of the count kernel's 4 x 256 counts, so pass
// p = shift / 8 finds digit d's base at bases[p * 256 + d] - p * n.  Otherwise
// (digit_rank, ITEMS = 4, tile = block): `bases` is bucket-major per block,
// dst is written, nothing moves.  dst, hist_t and scanned may be null.
template <int ITEMS, bool ONESWEEP>
__global__ void __launch_bounds__(THREADS)
digit_pass_kernel(const long long* __restrict__ keys, const unsigned* __restrict__ values,
                  long long* __restrict__ keys_out, unsigned* __restrict__ values_out,
                  const int* __restrict__ bases, int* __restrict__ dst,
                  int* __restrict__ hist_t, int* __restrict__ scanned,
                  u64* __restrict__ status, u64* __restrict__ control,
                  int n, int nblocks, int shift)
{
    constexpr int TILE = THREADS * ITEMS;
    constexpr int WARP_KEYS = 32 * ITEMS;       // consecutive keys a warp ranks
    constexpr int SUB = TILE / BLOCK_KEYS;      // 1024-key blocks in a tile
    constexpr int WARPS_PER_BLOCK = WARPS / SUB;
    static_assert(TILE % BLOCK_KEYS == 0 && WARPS % SUB == 0, "tile = whole blocks of whole warps");
    static_assert(ONESWEEP || SUB == 1, "digit_rank's bases are per 1024-key block");

    // The per-warp counts, then the staged keys, then the staged values share
    // this buffer: each is dead before the next is written.
    __shared__ long long stage[TILE];
    __shared__ int dest_of[BUCKETS];   // output position of the tile's staged slot 0 of digit d
    __shared__ int warp_sums[WARPS];
    __shared__ int tile_s;
    __shared__ unsigned epoch_s;
    int(*counts)[BUCKETS] = reinterpret_cast<int(*)[BUCKETS]>(stage);
    unsigned* stage_v = reinterpret_cast<unsigned*>(stage);

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;

    if (ONESWEEP) {
        if (tid == 0) {
            const u64 c = atomicAdd(control, 1ull);
            const unsigned ticket = (unsigned)c;
            // The last ticket: the next epoch, no tickets drawn.
            if (ticket == gridDim.x - 1) atomicAdd(control, (1ull << 32) - gridDim.x);
            tile_s = (int)ticket;
            epoch_s = (unsigned)(c >> 32) & EPOCH_MASK;
        }
    } else if (tid == 0) {
        tile_s = blockIdx.x;
    }
#pragma unroll
    for (int w = 0; w < WARPS; ++w) counts[w][tid] = 0;
    __syncthreads();
    const int tile = tile_s;
    const long long first = (long long)tile * TILE + warp * WARP_KEYS + lane;

    long long key[ITEMS];
    unsigned val[ITEMS];
    int pos[ITEMS];  // rank in the warp's round, then the slot in the staged tile
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
        const long long i = first + r * 32;
        key[r] = i < n ? __ldg(keys + i) : -1;
        if (ONESWEEP) val[r] = i < n ? __ldg(values + i) : 0u;
    }

    const unsigned lanes_below = (1u << lane) - 1u;
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
        const bool valid = first + r * 32 < n;
        const int d = valid ? digit_of(key[r], shift) : NO_DIGIT;
        const unsigned peers = peers_of(d);
        const int seen = valid ? counts[warp][d] : 0;
        pos[r] = seen + __popc(peers & lanes_below);
        __syncwarp();
        if (valid && lane == __ffs(peers) - 1) counts[warp][d] = seen + __popc(peers);
        __syncwarp();
    }
    __syncthreads();

    // Thread tid serves digit tid: counts[w][tid] becomes the number of the
    // tile's keys of that digit in warps before w; `total` the tile's count.
    int total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
        const int c = counts[w][tid];
        counts[w][tid] = total;
        total += c;
    }

    // Where the tile's first key of digit tid goes.
    int base;
    if (ONESWEEP) {
        const unsigned epoch = epoch_s;
        const unsigned tag = epoch << 2;
        u64* mine = status + (long long)tile * BUCKETS + tid;
        int before = 0;  // keys of digit tid in earlier tiles
        if (tile == 0) {
            store_relaxed(mine, ((u64)(tag | ST_PREFIX) << 32) | (unsigned)total);
        } else {
            store_relaxed(mine, ((u64)(tag | ST_AGGREGATE) << 32) | (unsigned)total);
            // Look back LOOKBACK predecessors at a time: the window's loads are
            // issued together, then each is polled until it is published
            // (tiles below 0 read as a prefix of 0); the counts are added
            // down to the nearest inclusive prefix.
            for (long long top = tile - 1;; top -= LOOKBACK) {
                u64 w[LOOKBACK];
#pragma unroll
                for (int j = 0; j < LOOKBACK; ++j)
                    w[j] = top - j >= 0 ? load_relaxed(status + (top - j) * BUCKETS + tid)
                                        : (u64)(tag | ST_PREFIX) << 32;
                bool found = false;
#pragma unroll
                for (int j = 0; j < LOOKBACK; ++j) {
                    if (found) break;
                    while (state_of(w[j], epoch) == 0)
                        w[j] = load_relaxed(status + (top - j) * BUCKETS + tid);
                    before += (int)(unsigned)w[j];
                    found = state_of(w[j], epoch) == ST_PREFIX;
                }
                if (found) break;
            }
            store_relaxed(mine, ((u64)(tag | ST_PREFIX) << 32) | (unsigned)(before + total));
        }
        const unsigned pass = (unsigned)shift / 8u;
        base = (int)((unsigned)bases[pass * BUCKETS + tid] - pass * (unsigned)n) + before;
    } else {
        base = bases[(long long)tid * nblocks + tile];
    }

    // The per-block observables.
#pragma unroll
    for (int s = 0; s < SUB; ++s) {
        const long long b = (long long)tile * SUB + s;
        if (b < nblocks) {
            const int lo = counts[s * WARPS_PER_BLOCK][tid];
            const int hi = s + 1 < SUB ? counts[(s + 1) * WARPS_PER_BLOCK][tid] : total;
            if (hist_t) hist_t[(long long)tid * nblocks + b] = hi - lo;
            if (scanned) scanned[(long long)tid * nblocks + b] = base + lo;
        }
    }

    // Slot of the tile's first key of digit tid once the tile is sorted by
    // digit: an exclusive scan of the totals over the 256 digits.
    const int incl = warp_inclusive_scan(total, lane);
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        const int ws = lane < WARPS ? warp_sums[lane] : 0;
        const int wi = warp_inclusive_scan(ws, lane);
        if (lane < WARPS) warp_sums[lane] = wi - ws;
    }
    __syncthreads();
    const int slot0 = warp_sums[warp] + incl - total;
    dest_of[tid] = base - slot0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) counts[w][tid] += slot0;
    __syncthreads();

    // pos: slot in the staged tile; its destination is dest_of[digit] + slot.
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
        const long long i = first + r * 32;
        if (i < n) {
            const int d = digit_of(key[r], shift);
            pos[r] += counts[warp][d];
            if (dst) dst[i] = dest_of[d] + pos[r];
        }
    }
    if (!ONESWEEP) return;
    __syncthreads();  // the counts are dead: the buffer takes the keys

    const int in_tile = (int)min((long long)TILE, (long long)n - (long long)tile * TILE);
#pragma unroll
    for (int r = 0; r < ITEMS; ++r)
        if (first + r * 32 < n) stage[pos[r]] = key[r];
    __syncthreads();
    int to[ITEMS];  // output position of staged slot j * THREADS + tid
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
        const int slot = j * THREADS + tid;
        if (slot < in_tile) {
            const long long k = stage[slot];
            to[j] = dest_of[digit_of(k, shift)] + slot;
            // Bases that do not belong to these keys would send a key past the
            // output: stop the kernel rather than write there.
            if ((unsigned)to[j] >= (unsigned)n) __trap();
            keys_out[to[j]] = k;
        }
    }
    __syncthreads();  // the keys are written: the buffer takes the values
#pragma unroll
    for (int r = 0; r < ITEMS; ++r)
        if (first + r * 32 < n) stage_v[pos[r]] = val[r];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
        const int slot = j * THREADS + tid;
        if (slot < in_tile) values_out[to[j]] = stage_v[slot];
    }
}

// Every entry point launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() as an int (-1 for an
// argument it does not take).

// The four passes' digit counts: out (1024,) int32; scratch holds the count's
// ticket (one 32-bit word) and 1024 running totals, all zero when first used.
extern "C" int digit_count_launch(
    const void* keys, void* out, void* scratch, int n, void* stream)
{
    if (n <= 0) return -1;
    const unsigned blocks = (unsigned)((n + (long long)COUNT_CHUNK - 1) / COUNT_CHUNK);
    unsigned* s = (unsigned*)scratch;
    digit_count_kernel<true><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const long long*)keys, (int*)out, s + 2, s, n, 0, 0);
    return (int)cudaGetLastError();
}

// Per-1024-key-block histogram of one digit: hist_t (256 * nblocks,) int32.
extern "C" int digit_histogram_launch(
    const void* keys, void* hist_t, int nblocks, int shift, void* stream)
{
    if (nblocks <= 0) return -1;
    const unsigned blocks = (unsigned)((nblocks + COUNT_ROWS - 1) / COUNT_ROWS);
    digit_count_kernel<false><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const long long*)keys, (int*)hist_t, nullptr, nullptr,
        nblocks * BLOCK_KEYS, nblocks, shift);
    return (int)cudaGetLastError();
}

// One digit pass: keys/values (n,) into keys_out/values_out; bases (1024,) the
// exclusive scan of digit_count's output; dst (n,), hist_t and scanned
// (256 * ceil(n / 1024),) int32 or null.  status holds `cap` * 256 64-bit
// words (cap >= the tile count) and control one, all zero when first used.
extern "C" int digit_pass_launch(
    const void* keys, const void* values, void* keys_out, void* values_out,
    const void* bases, void* dst, void* hist_t, void* scanned,
    void* status, void* control, int n, long long cap, int shift, void* stream)
{
    const long long tiles = (n + (long long)THREADS * PASS_ITEMS - 1) / (THREADS * PASS_ITEMS);
    if (n <= 0 || tiles > cap) return -1;
    const int nblocks = (int)((n + (long long)BLOCK_KEYS - 1) / BLOCK_KEYS);
    digit_pass_kernel<PASS_ITEMS, true><<<(unsigned)tiles, THREADS, 0, (cudaStream_t)stream>>>(
        (const long long*)keys, (const unsigned*)values, (long long*)keys_out,
        (unsigned*)values_out, (const int*)bases, (int*)dst, (int*)hist_t, (int*)scanned,
        (u64*)status, (u64*)control, n, nblocks, shift);
    return (int)cudaGetLastError();
}

// Destinations of one stable pass from bucket-major per-block bases: dst (n,)
// int32, n a multiple of 1024.
extern "C" int digit_rank_launch(
    const void* keys, const void* bases, void* dst, int nblocks, int shift, void* stream)
{
    if (nblocks <= 0) return -1;
    digit_pass_kernel<BLOCK_KEYS / THREADS, false><<<nblocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const long long*)keys, nullptr, nullptr, nullptr, (const int*)bases, (int*)dst,
        nullptr, nullptr, nullptr, nullptr, nblocks * BLOCK_KEYS, nblocks, shift);
    return (int)cudaGetLastError();
}
