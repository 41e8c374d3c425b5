"""The primitive-cost probes of the port (``benchmarks/kernel_probe.py``): each
plain version against a numpy loop written here and against the closed form
where the loop has one, and the entry point on ``--device cpu``.

There is no JAX function to run beside them: the JAX package's
``benchmarks/kernel_probe.py`` keeps its two kernels as closures inside
``main()``, with no interpret switch, and runs them only on a TPU.  What is
held here is the arithmetic the CUDA kernels repeat (``chip_smoke.py`` and
``tests/test_torch_kernel_gpu.py`` hold the kernels to these plain versions,
bit for bit, on the card).  Inputs come from a seed through numpy.  Tolerance:
exact — the tables hold small integers, every sum stays below 2^24; the one
float chain (``vector_40ops``) is compared bit for bit with the same float32
operations in numpy.
"""
import json

import numpy as np
import pytest
import torch

from unitysimpleraytracing_tpu_torch.benchmarks import kernel_probe as kp

from _torch_common import CPU, t_

JAX_P1_NAMES = ["empty", "fetch_x1", "fetch_x4", "fetch_x8", "fetch_x16", "fetch_x32",
                "reduce_sum_8x128", "reduce_sum_x2", "vector_40ops", "fetch_packed_switch8_x2"]
JAX_P2 = {"dma_row512_serial": (1, 1), "dma_row512_batch2": (2, 1), "dma_row512_batch4": (4, 1),
          "dma_row512_batch8": (8, 1), "dma_row2048_batch8": (8, 4)}


def _table(seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 8, size=(4096, 16)).astype(np.float32)


def numpy_probe(name, tab, n):
    """The loop of probe ``name`` in numpy float32 scalars, step by step."""
    f32 = np.float32
    s, v = f32(0), np.zeros((8, 128), f32)
    chase, stack = 0, np.zeros(64, f32)
    for i in range(n):
        if name == "empty" or name == "empty_block1024":
            s = s + f32(1)
        elif name.startswith("fetch_x"):
            r = (i * 37 + 11) & 4095
            for c in range(int(name[len("fetch_x"):])):
                s = s + tab[r, c % 16]
        elif name == "reduce_sum_8x128":
            s = s + np.sum(v + f32(1), dtype=f32)
        elif name == "reduce_sum_x2":
            s = s + np.sum(v + f32(1), dtype=f32) + np.sum(v + f32(2), dtype=f32)
        elif name == "vector_40ops":
            x = v
            for _ in range(10):
                x = x * f32(1.0001) + f32(0.5)
                x = np.minimum(x, f32(3))
                x = np.maximum(x, f32(-3))
                x = x - f32(0.1)
            v = x
        elif name == "fetch_packed_switch8_x2":
            r = (i * 37 + 11) & (4096 * 8 - 1)
            s = s + tab[r // 8, 2 * (r & 7)] + tab[r // 8, 2 * (r & 7) + 1]
        elif name in ("dep_fetch_l1_x1", "dep_fetch_l2_x1", "dep_fetch_smem_x1"):
            val = tab[chase, 0]
            s = s + val
            chase = (chase * 37 + 11 + int(val)) & (2047 if "smem" in name else 4095)
        elif name in ("dep_fetch_l1_row64", "dep_fetch_l2_row64"):
            row = tab[chase]
            val = ((row[0] + row[5]) + row[10]) + row[15]
            s = s + val
            chase = (chase * 37 + 11 + int(val)) & 4095
        else:
            assert name == "dep_local_stack_x1"
            w = (i * 37 + 11) & 63
            stack[w] = f32(i & 7)
            s = s + stack[(int(s) + w * 5 + 3) & 63]
    assert s.dtype == np.float32 and v.dtype == np.float32
    return s + v[0, 0]


def test_probe_names_are_the_jax_script_s_and_more():
    assert list(kp.P1_JAX_NAMES) == JAX_P1_NAMES
    assert {n: v for n, v in kp.P2_VARIANTS.items()} == JAX_P2
    assert set(kp.P1_NEW_NAMES).isdisjoint(JAX_P1_NAMES) and len(kp.P1_NEW_NAMES) == 7
    assert kp.TAB_SHAPE == (4096, 16) and kp.L2_ROWS == 1 << 15
    assert (kp.LCG_A, kp.LCG_C) == (1103515245, 12345)
    # The reductions run the whole (8, 128) vector carry: 1024 threads.
    for name, (_, _, threads) in kp.P1_VARIANTS.items():
        assert threads == (1024 if name in ("reduce_sum_8x128", "reduce_sum_x2", "vector_40ops",
                                            "empty_block1024") else 32)


@pytest.mark.parametrize("name", list(kp.P1_VARIANTS))
def test_p1_plain_version_equals_numpy_loop(name):
    tab = _table(seed=3)
    n = 150
    got = kp.run_probe_plain(name, t_(tab), n)
    assert tuple(got.shape) == (1,) and got.dtype == torch.float32
    want = numpy_probe(name, tab, n)
    assert got.numpy()[0].view(np.uint32) == np.float32(want).view(np.uint32), (got, want)
    assert float(kp.run_probe_plain(name, t_(tab), 0)) == 0.0


@pytest.mark.parametrize("name", JAX_P1_NAMES)
def test_p1_closed_forms(name):
    """Where the loop has a closed form it is met, at the count the entry
    point's default would reach in proportion (values stay below 2^24)."""
    tab = _table(seed=0)
    n = 300
    got = float(kp.run_probe_plain(name, t_(tab), n))
    rows = (np.arange(n) * 37 + 11) & 4095
    if name == "empty":
        assert got == n
    elif name.startswith("fetch_x"):
        k = int(name[len("fetch_x"):])
        cols = np.arange(k) % 16
        assert got == float(tab[rows][:, cols].astype(np.float64).sum())
    elif name == "reduce_sum_8x128":
        assert got == 1024.0 * n
    elif name == "reduce_sum_x2":
        assert got == 3072.0 * n
    elif name == "vector_40ops":
        # x -> min(x * 1.0001 + 0.5, 3) - 0.1 climbs to its fixed point 2.9.
        assert got == float(np.float32(3.0) - np.float32(0.1))
    else:
        r = (np.arange(n) * 37 + 11) & (4096 * 8 - 1)
        want = tab[r // 8, 2 * (r & 7)].astype(np.float64) + tab[r // 8, 2 * (r & 7) + 1]
        assert got == float(want.sum())


def test_p1_sums_stay_exact_at_the_default_count():
    """32 fetches x 20000 iterations x the largest table value is below 2^24,
    so float32 sums are exact whatever order a reduction takes."""
    assert 32 * 20000 * (kp.TABLE_VALUES - 1) < 2**24
    tab = kp.make_table(seed=5, device=CPU)
    assert tab.dtype == torch.float32 and tuple(tab.shape) == kp.TAB_SHAPE
    assert bool(((tab >= 0) & (tab < kp.TABLE_VALUES) & (tab == tab.round())).all())
    assert torch.equal(tab, kp.make_table(seed=5, device=CPU))
    assert not torch.equal(tab, kp.make_table(seed=6, device=CPU))


def numpy_dma_probe(table, depth, rpr, rounds):
    """P2's chain in numpy: LCG indices, ``depth`` row copies, accumulate,
    fold the fetched data into the next round's base."""
    rows = table.shape[0] // rpr
    scratch = np.zeros((depth * rpr, 128), np.float32)
    base, acc = 1, np.float32(0)
    visited = []
    for _ in range(rounds):
        x, idxs = base, []
        for _ in range(depth):
            x = (x * 1103515245 + 12345) & (rows - 1)
            idxs.append(x)
        for j, idx in enumerate(idxs):
            scratch[j * rpr:(j + 1) * rpr] = table[idx * rpr:(idx + 1) * rpr]
        for j in range(depth):
            acc = acc + scratch[j * rpr, 0]
        base = idxs[-1] ^ int(scratch[0, 1])
        visited += idxs
    return acc, visited


@pytest.mark.parametrize("neutral", [True, False])
@pytest.mark.parametrize("name", list(JAX_P2))
def test_p2_plain_version_equals_numpy_chain(name, neutral):
    depth, rpr = JAX_P2[name]
    rows = 256
    rng = np.random.default_rng(7)
    table = rng.integers(0, 8, size=(rows * rpr, 128)).astype(np.float32)
    if neutral:
        table[:, 1] = 0
    rounds = 64 // depth
    got = kp.run_dma_probe_plain(t_(table), depth, rpr, rounds)
    want, visited = numpy_dma_probe(table, depth, rpr, rounds)
    assert tuple(got.shape) == (1,) and float(got) == float(want)
    if neutral:
        # The chain is then the LCG alone: no row twice within its period, and
        # the output is the sum of the visited rows' first elements.
        assert len(set(visited)) == len(visited) == rounds * depth
        assert float(got) == float(table[np.asarray(visited) * rpr, 0].astype(np.float64).sum())
    else:
        x, plain_lcg = 1, []
        for _ in range(rounds * depth):
            x = (x * 1103515245 + 12345) & (rows - 1)
            plain_lcg.append(x)
        assert visited != plain_lcg, "the fetched data did not steer the chain"


def test_lcg_chain_over_a_neutral_table_has_full_period():
    """Why the timed tables zero column 1: the LCG visits every row once per
    period; with data folded in, the orbit falls into a short cycle."""
    rows = 1 << 10
    x, seen = 1, []
    for _ in range(rows):
        x = (x * kp.LCG_A + kp.LCG_C) & (rows - 1)
        seen.append(x)
    assert len(set(seen)) == rows
    rng = np.random.default_rng(0)
    table = rng.integers(0, 8, size=(rows, 128)).astype(np.float32)
    _, visited = numpy_dma_probe(table, 1, 1, rows)
    assert len(set(visited)) < rows // 4


def test_dma_table_and_rounds():
    t = kp.make_dma_table(seed=1, rows=64, rows_per_rec=4, device=CPU)
    assert tuple(t.shape) == (256, 128) and t.dtype == torch.float32
    assert bool((t[:, 1] == 0).all()) and bool((t[:, 0] != 0).any())
    assert bool(((t >= 0) & (t < kp.TABLE_VALUES)).all())
    steering = kp.make_dma_table(seed=1, rows=64, rows_per_rec=4, device=CPU, chain_neutral=False)
    assert bool((steering[:, 1] != 0).any())
    assert kp.dma_rounds(20000, 1) == 2000 and kp.dma_rounds(20000, 8) == 250
    assert kp.dma_rounds(300, 4) == 250  # the JAX script's floor of 1000 rows


def test_wrappers_refuse_what_the_kernels_do_not_take():
    tab = kp.make_table(device=CPU)
    with pytest.raises(KeyError, match="no probe"):
        kp.probe_kernel("fetch_x3", tab, 4)
    with pytest.raises(ValueError, match="contiguous float32"):
        kp.probe_kernel("empty", tab[:, :8], 4)
    with pytest.raises(ValueError, match="contiguous float32"):
        kp.probe_kernel("empty", tab.double(), 4)
    table = kp.make_dma_table(rows=64, device=CPU)
    with pytest.raises(ValueError, match="depth in"):
        kp.dma_probe_kernel(table, 3, 1, 4)
    with pytest.raises(ValueError, match="power of two"):
        kp.dma_probe_kernel(table[:48], 1, 1, 4)
    with pytest.raises(ValueError, match="contiguous float32"):
        kp.dma_probe_kernel(table[:, :64], 1, 1, 4)


def test_entry_point_prints_the_jax_script_s_lines_on_the_cpu(capsys):
    lines = kp.main(["--iters", "40", "--seed", "2", "--device", "cpu"])
    out = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert out == lines
    p1 = [ln for ln in out if "ns_per_iter" in ln]
    p2 = [ln for ln in out if "ns_per_row" in ln]
    assert [ln["probe"] for ln in p1] == list(kp.P1_VARIANTS)
    assert [ln["probe"] for ln in p1][:10] == JAX_P1_NAMES
    # On the CPU there is no device-memory pass: the five JAX names only.
    assert [ln["probe"] for ln in p2] == list(JAX_P2)
    for ln in p2:
        assert ln["bytes_per_row"] == 512 * JAX_P2[ln["probe"]][1]
        assert ln["rows_fetched"] == 1000 // ln["depth"] * ln["depth"]
    for ln in out:
        assert ln["device"] == "cpu" and "host clock" in ln["timing"]
        assert ln.get("ns_per_iter", ln.get("ns_per_row")) > 0 and np.isfinite(ln["value"])
    tab = kp.make_table(2, CPU)
    assert out[0]["value"] == 40.0
    assert out[5]["value"] == float(kp.run_probe_plain("fetch_x32", tab, 40))


def test_entry_point_raises_instead_of_printing_an_error_line():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device does not raise here")
    with pytest.raises(RuntimeError, match="CUDA"):
        kp.main(["--iters", "10"])
