"""The count and the pass of ``csrc/radix_sort.cu`` as the card runs them, on
the CPU.

The kernels cannot run here, so each is mirrored by scalar numpy code with
the kernel's own index arithmetic: the count's 16-byte loads (thread t of a
block reads keys ``chunk + 512 j + 2 t`` and ``+ 1``), its warp votes and its
last-ticket hand-over of the totals; the pass's ticketed tiles, warp-round
ranks from one ballot per digit bit, status words published and read in
seeded random interleavings of the thread blocks' digit threads (each tile's
count before its inclusive prefix, words of an earlier epoch left in the
scratch), the windowed look-back, and the shared-memory staging of each tile
in digit order.  The mirrors are held to the plain versions that the card's
kernels are held to (``digit_counts_plain``, ``digit_pass_plain``,
``digit_histogram_plain``) bit for bit, on the key distributions of
``tests/test_torch_sort.py`` and all-equal keys, at one to a few tiles; and
the plain pass to the JAX package's ``"pallas"`` pass in interpret mode.
Tolerance: none — integers, exact.
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unitysimpleraytracing_tpu.ops import sort_pallas as jsp
from unitysimpleraytracing_tpu_torch import constants as C
from unitysimpleraytracing_tpu_torch.ops import scan as pscan
from unitysimpleraytracing_tpu_torch.ops import sort as psort
from unitysimpleraytracing_tpu_torch.ops import sort_radix_cuda as pcu
from unitysimpleraytracing_tpu_torch.utils import kernel_build

from _torch_common import assert_same_bits, n_, t_
from test_torch_sort import _kv

FULL = 0xFFFFFFFF
NO_DIGIT = 256
ST_AGGREGATE, ST_PREFIX = 1, 2
EPOCH_MASK = (1 << 30) - 1


def _cu_defines():
    text = open(os.path.join(kernel_build.CSRC_DIR, pcu.KERNEL_NAME + ".cu"),
                encoding="utf-8").read()
    return {m[1]: int(m[2]) for m in re.finditer(r"^#define (\w+) (\d+)\b", text, re.M)}


_D = _cu_defines()
THREADS, BUCKETS, BLOCK_KEYS = _D["THREADS"], _D["BUCKETS"], _D["BLOCK_KEYS"]
WARPS = THREADS // 32
COUNT_ITEMS, PASS_ITEMS, LOOKBACK = _D["COUNT_ITEMS"], _D["PASS_ITEMS"], _D["LOOKBACK"]
TILE = THREADS * PASS_ITEMS
SIZES = [1, TILE + 37, 2 * TILE + 1029]   # one, two and three tiles of the pass
KINDS = ["random", "duplicates", "padding", "ragged", "equal"]


def _keys(kind, n, seed):
    if kind == "equal":
        return np.full(n, 0x2AAAAAAA, np.int64), np.arange(n, dtype=np.int32)
    keys, values = _kv(kind, n, seed)
    return keys.astype(np.int64), values


def digit_of(keys, shift):
    return (keys >> shift) & (BUCKETS - 1)


def peers_of(d):
    """``peers_of`` of the kernel for one warp: 32 digits -> 32 masks, from
    one ballot per bit of the digit (nine bits)."""
    peers = np.full(32, FULL, np.uint64)
    lanes = np.arange(32, dtype=np.uint64)
    for b in range(9):
        bit = ((d >> b) & 1).astype(bool)
        m = np.uint64(int(((bit.astype(np.uint64)) << lanes).sum()))
        peers &= np.where(bit, m, ~m & np.uint64(FULL))
    return peers


def popc(x):
    return np.array([bin(int(v)).count("1") for v in x])


# ---- the count ---------------------------------------------------------------


def count_mirror(keys, rng, shift=None):
    """digit_count_kernel: with ``shift`` None, all four digits into the
    running totals, handed out by the block that draws the last ticket (the
    blocks finish in a seeded random order); with a shift, the per-1024-key
    block histogram of one digit, bucket-major."""
    n = keys.shape[0]
    chunk_keys = THREADS * COUNT_ITEMS
    blocks = -(-n // chunk_keys)
    rows = chunk_keys // BLOCK_KEYS
    accum = np.zeros(4 * BUCKETS, np.int64)
    ticket, out = 0, None
    nblocks = -(-n // BLOCK_KEYS)
    hist_t = np.full(BUCKETS * nblocks, -1, np.int64)
    for blk in rng.permutation(blocks):
        hist = np.zeros((rows, BUCKETS), np.int64)
        chunk = blk * chunk_keys
        for j in range(COUNT_ITEMS):
            for warp in range(WARPS):
                tids = warp * 32 + np.arange(32)
                idx = chunk + (j >> 1) * 2 * THREADS + 2 * tids + (j & 1)
                valid = idx < n
                k = keys[np.minimum(idx, n - 1)]
                for q in (range(4) if shift is None else [j >> 2]):
                    s = 8 * q if shift is None else shift
                    d = np.where(valid, digit_of(k, s), NO_DIGIT)
                    if np.all(d == d[0]):          # the warp's vote
                        if d[0] != NO_DIGIT:
                            hist[q, d[0]] += 32
                    else:
                        np.add.at(hist[q], d[valid], 1)
        if shift is not None:
            for q in range(rows):
                b = blk * rows + q
                if b < nblocks:
                    hist_t[np.arange(BUCKETS) * nblocks + b] = hist[q]
            continue
        accum += hist.reshape(-1)
        ticket += 1
        if ticket == blocks:                       # the last block
            out, accum[:], ticket = accum.copy(), 0, 0
    if shift is not None:
        return hist_t
    assert out is not None and not accum.any() and ticket == 0
    return out


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", KINDS)
def test_count_mirror_equals_bincount_and_the_plain_count(kind, n):
    keys, _ = _keys(kind, n, seed=n)
    got = count_mirror(keys, np.random.default_rng(n))
    for p in range(4):
        want = np.bincount(digit_of(keys, 8 * p), minlength=BUCKETS)
        np.testing.assert_array_equal(got[p * BUCKETS:(p + 1) * BUCKETS], want)
    plain = pcu.digit_counts_plain(t_(keys))
    assert plain.dtype == torch.int32
    np.testing.assert_array_equal(got, n_(plain))
    assert torch.equal(pcu.digit_counts(t_(keys)), plain)


@pytest.mark.parametrize("kind", KINDS)
def test_per_block_histogram_mirror_equals_the_plain_version(kind):
    keys, _ = _keys(kind, 5 * BLOCK_KEYS, seed=3)
    keys = keys[:5 * BLOCK_KEYS]          # a whole number of blocks, not of count chunks
    for shift in pcu.SHIFTS:
        got = count_mirror(keys, np.random.default_rng(shift), shift=shift)
        np.testing.assert_array_equal(got, n_(pcu.digit_histogram_plain(t_(keys), shift)))


# ---- the pass ----------------------------------------------------------------


def _word(tag, value):
    return (tag << 32) | (value & FULL)


def _state(w, epoch):
    tag = w >> 32
    return tag & 3 if (tag >> 2) == epoch else 0


class PassMirror:
    """One digit_pass_kernel launch.  Each thread block is a generator that
    draws its ticket, ranks its tile, then runs its 256 digit threads as
    generators of their own (publish, look back, publish), and after them
    moves its tile; a seeded scheduler steps one runnable generator at a
    time, so blocks and digit threads interleave at every status-word load
    and store."""

    def __init__(self, keys, values, bases, shift, status, control, rng, window=LOOKBACK):
        self.keys, self.values, self.bases, self.shift = keys, values, bases, shift
        self.status, self.control, self.rng, self.window = status, control, rng, window
        self.n = keys.shape[0]
        self.tiles = -(-self.n // TILE)
        self.nblocks = -(-self.n // BLOCK_KEYS)
        self.keys_out = np.full(self.n, -1, np.int64)
        self.values_out = np.full(self.n, -1, np.int64)
        self.dst = np.full(self.n, -1, np.int64)
        self.hist_t = np.full(BUCKETS * self.nblocks, -1, np.int64)
        self.scanned = np.full(BUCKETS * self.nblocks, -1, np.int64)

    def run(self, max_steps=5_000_000):
        pool = [self.block() for _ in range(self.tiles)]
        steps = 0
        while pool:
            i = int(self.rng.integers(len(pool)))
            try:
                spawned = next(pool[i])
            except StopIteration:
                pool.pop(i)
                continue
            if spawned:
                pool.extend(spawned)
            steps += 1
            assert steps < max_steps, "the pass does not finish: a look-back waits forever"
        return self

    def block(self):
        c = self.control[0]
        self.control[0] += 1
        ticket, epoch = c & FULL, (c >> 32) & EPOCH_MASK
        if ticket == self.tiles - 1:              # the last ticket: the next epoch
            self.control[0] += (1 << 32) - self.tiles
        tile = ticket
        yield None
        n, shift = self.n, self.shift
        warp_keys = 32 * PASS_ITEMS
        counts = np.zeros((WARPS, BUCKETS), np.int64)
        idx = np.zeros((WARPS, PASS_ITEMS, 32), np.int64)
        pos = np.zeros((WARPS, PASS_ITEMS, 32), np.int64)
        below = (np.uint64(1) << np.arange(32, dtype=np.uint64)) - np.uint64(1)
        for w in range(WARPS):
            for r in range(PASS_ITEMS):
                i = tile * TILE + w * warp_keys + r * 32 + np.arange(32)
                valid = i < n
                d = np.where(valid, digit_of(self.keys[np.minimum(i, n - 1)], shift), NO_DIGIT)
                peers = peers_of(d)
                seen = np.where(valid, counts[w, np.minimum(d, BUCKETS - 1)], 0)
                pos[w, r] = seen + popc(peers & below)
                for lane in np.nonzero(valid)[0]:
                    if lane == (int(peers[lane]) & -int(peers[lane])).bit_length() - 1:
                        counts[w, d[lane]] = seen[lane] + popc(peers[lane:lane + 1])[0]
                idx[w, r] = i
        excl = np.cumsum(counts, 0) - counts       # keys of a digit in earlier warps
        total = counts.sum(0)
        before = np.zeros(BUCKETS, np.int64)
        threads = [self.digit_thread(tile, epoch, d, int(total[d]), before)
                   for d in range(BUCKETS)]
        remaining = [len(threads)]
        yield [self.until_done(t, remaining) for t in threads]
        while remaining[0]:
            yield None
        # The digit bases, the observables, and the move.
        p = shift // 8
        base = ((self.bases[p * BUCKETS:(p + 1) * BUCKETS] - p * n) % (1 << 32)) + before
        sub = TILE // BLOCK_KEYS
        wpb = WARPS // sub
        for s in range(sub):
            b = tile * sub + s
            if b < self.nblocks:
                lo = excl[s * wpb]
                hi = excl[(s + 1) * wpb] if s + 1 < sub else total
                self.hist_t[np.arange(BUCKETS) * self.nblocks + b] = hi - lo
                self.scanned[np.arange(BUCKETS) * self.nblocks + b] = base + lo
        slot0 = np.cumsum(total) - total
        dest_of = base - slot0
        in_tile = min(TILE, n - tile * TILE)
        stage_k = np.full(in_tile, -1, np.int64)
        stage_v = np.full(in_tile, -1, np.int64)
        for w in range(WARPS):
            for r in range(PASS_ITEMS):
                for lane in range(32):
                    i = idx[w, r, lane]
                    if i < n:
                        d = digit_of(self.keys[i], shift)
                        slot = pos[w, r, lane] + excl[w, d] + slot0[d]
                        self.dst[i] = dest_of[d] + slot
                        assert stage_k[slot] == -1, "two keys staged in one slot"
                        stage_k[slot], stage_v[slot] = self.keys[i], self.values[i]
        # The staged tile is the tile stably sorted by digit.
        tile_keys = self.keys[tile * TILE:tile * TILE + in_tile]
        order = np.argsort(digit_of(tile_keys, shift), kind="stable")
        np.testing.assert_array_equal(stage_k, tile_keys[order])
        for slot in range(in_tile):
            to = dest_of[digit_of(stage_k[slot], shift)] + slot
            self.keys_out[to], self.values_out[to] = stage_k[slot], stage_v[slot]

    @staticmethod
    def until_done(thread, remaining):
        yield from thread
        remaining[0] -= 1

    def digit_thread(self, tile, epoch, d, total, before):
        tag = epoch << 2
        status = self.status
        mine = tile * BUCKETS + d
        if tile == 0:
            status[mine] = _word(tag | ST_PREFIX, total)
            yield None
            return
        status[mine] = _word(tag | ST_AGGREGATE, total)
        yield None
        acc, top = 0, tile - 1
        while True:
            w = []
            for j in range(self.window):
                w.append(status[(top - j) * BUCKETS + d] if top - j >= 0
                         else _word(tag | ST_PREFIX, 0))
                yield None
            found = False
            for j in range(self.window):
                if found:
                    break
                while _state(w[j], epoch) == 0:
                    yield None
                    w[j] = status[(top - j) * BUCKETS + d]
                acc += w[j] & FULL
                found = _state(w[j], epoch) == ST_PREFIX
            if found:
                break
            top -= self.window
        before[d] = acc
        status[mine] = _word(tag | ST_PREFIX, acc + total)
        yield None


def _stale_scratch(tiles, rng, epoch):
    """Status words left by the previous epoch's calls (counts and prefixes
    that must not be read as this call's), and the control word."""
    status = np.array([_word(((epoch - 1) & EPOCH_MASK) << 2 | int(s), int(v))
                       for s, v in zip(rng.integers(0, 3, size=tiles * BUCKETS),
                                       rng.integers(0, 1 << 20, size=tiles * BUCKETS))],
                      dtype=object)
    return status, [epoch << 32]


@pytest.mark.parametrize("kind, n, window", [(k, n, LOOKBACK) for k in KINDS for n in SIZES]
                         + [(k, SIZES[-1], 1) for k in ("random", "padding")])
def test_pass_mirror_equals_the_plain_pass_in_every_output(kind, n, window):
    """The four passes of one sort on one stream's scratch, each launch
    moving the epoch on, each output held to `digit_pass_plain`; a window of
    one word makes the last tile walk over a count to reach a prefix."""
    keys, values = _keys(kind, n, seed=n + 1)
    rng = np.random.default_rng(n * 7 + len(kind))
    tiles = -(-n // TILE)
    status, control = _stale_scratch(tiles, rng, epoch=int(rng.integers(1, 1000)))
    counts = count_mirror(keys, rng)
    bases = n_(pscan.exclusive_scan_plain(t_(counts.astype(np.int32))))
    k, v = keys, values
    for shift in pcu.SHIFTS:
        epoch = control[0] >> 32
        got = PassMirror(k, v, bases.astype(np.int64), shift, status, control, rng,
                         window).run()
        assert control[0] == (epoch + 1) << 32, "the last ticket moves the epoch on"
        want = pcu.digit_pass_plain(t_(k), t_(v), t_(bases), shift)
        for name, g, w in zip(("keys_out", "values_out", "dst", "hist_t", "scanned"),
                              (got.keys_out, got.values_out, got.dst, got.hist_t, got.scanned),
                              want):
            np.testing.assert_array_equal(g, n_(w).astype(np.int64), err_msg=f"{name}, shift {shift}")
        # Every tile published its inclusive prefix of every digit, in this epoch.
        assert all(_state(w, epoch) == ST_PREFIX for w in status[:tiles * BUCKETS])
        k, v = got.keys_out, got.values_out.astype(np.int32)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(k, keys[order])
    np.testing.assert_array_equal(v, values[order])


def test_peers_from_ballots_are_the_lanes_of_the_same_digit():
    rng = np.random.default_rng(0)
    for d in (rng.integers(0, 256, 32), np.full(32, 7), rng.integers(0, 3, 32),
              np.r_[rng.integers(0, 256, 20), np.full(12, NO_DIGIT)]):
        peers = peers_of(d)
        for lane in range(32):
            want = sum(1 << m for m in range(32) if d[m] == d[lane])
            assert int(peers[lane]) == want


def test_the_mirrors_use_the_kernel_source_and_the_wrapper_constants():
    """The constants above come from csrc/radix_sort.cu; the wrapper's tile
    and scratch layout agree with them."""
    assert TILE == pcu.TILE and BLOCK_KEYS == pcu.BLOCK and BUCKETS == C.NUM_BUCKETS
    assert THREADS * COUNT_ITEMS // BLOCK_KEYS == 4 and 1 <= LOOKBACK <= 32
    # Head words: the pass's control word, the count's ticket, 1024 32-bit totals.
    assert pcu._HEAD_WORDS == 2 + 1024 // 2 and pcu._STATUS_OFFSET == 8 * pcu._HEAD_WORDS


@pytest.mark.parametrize("shift", pcu.SHIFTS)
def test_plain_pass_equals_the_jax_pallas_pass(shift):
    """``digit_pass_plain`` against the JAX package's "pallas" pass
    (interpret mode) on the same 4096 keys: keys, values, hist_t, scanned,
    and dst against the JAX rank kernel."""
    keys, values = _kv("random", 4096, seed=20 + shift)
    pk = t_(keys.astype(np.int64))
    bases = pscan.exclusive_scan_plain(pcu.digit_counts_plain(pk))
    got = pcu.digit_pass_plain(pk, t_(values), bases, shift)
    want = jsp.pallas_pass_debug(jnp.asarray(keys), jnp.asarray(values), shift)
    for name, g, w in zip(("keys_out", "values_out", "hist_t", "scanned"),
                          (got[0], got[1], got[3], got[4]), want):
        assert_same_bits(g, w, name)
    nblocks = 4
    _, rank_call = jsp._pass_fns(nblocks, shift, True)
    jbases = jnp.asarray(want[3], jnp.float32).reshape(jsp._NB, nblocks).T
    want_dst = rank_call(jnp.asarray(keys).reshape(nblocks, 8, 128),
                         jbases.reshape(nblocks, 1, jsp._NB)).reshape(-1)
    assert_same_bits(got[2], want_dst, "dst")


def test_engine_runs_count_scan_and_four_passes_on_cpu_without_launches():
    keys, values = _keys("ragged", 3000, seed=5)
    ko, vo = pcu.radix_sort_key_val_cuda(t_(keys), t_(values))
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(n_(ko), keys[order])
    np.testing.assert_array_equal(n_(vo), values[order])
    vf = t_(values.astype(np.float32))
    assert torch.equal(pcu.radix_sort_key_val_cuda(t_(keys), vf)[1], vf[order])
    with pytest.raises(TypeError, match="4-byte"):
        psort.sort_key_val(t_(keys), t_(values.astype(np.int64)), impl="cuda")
    for f in (pcu.digit_counts, pcu.digit_pass, pcu.digit_histogram, pcu.digit_rank):
        assert f.launches == 0
