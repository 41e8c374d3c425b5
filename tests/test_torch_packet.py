"""Shared-stack packet traversal of the PyTorch port against the JAX package
and against the port's per-ray oracle.

Within the port the packet engine is bit-identical to `ops/trace.traverse`
(same blind left-then-right DFS, same elementwise float32 operations).
Against the JAX package: hit masks and triangle ids identical, t, u, v under
the parity contract (rtol 4e-6; u, v within 1e-5 · max(1, 0.1/|det|)) —
XLA:CPU fuses multiply-adds that eager PyTorch keeps apart, so the last bit
of t, u, v is not the JAX package's on every ray.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unitysimpleraytracing_tpu.ops import trace_packet as jpacket
from unitysimpleraytracing_tpu_torch.ops import dispatch as pdispatch
from unitysimpleraytracing_tpu_torch.ops import trace as ptrace
from unitysimpleraytracing_tpu_torch.ops import trace_packet as ppacket
from unitysimpleraytracing_tpu_torch.utils.parity import assert_hit_parity, grazing_factor

from _torch_common import both_built, n_, rays, t_

_FIELDS = ("t", "tri", "u", "v")


@pytest.mark.parametrize("h,w,tile", [(64, 96, 32), (32, 32, 32), (16, 24, 8)])
def test_tiled_ray_order_identical(h, w, tile):
    perm, inv = ppacket.tiled_ray_order(h, w, tile)
    jperm, jinv = jpacket.tiled_ray_order(h, w, tile)
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(inv, jinv)
    np.testing.assert_array_equal(perm[inv], np.arange(h * w))
    # The same permutation as the reshape/transpose form the renderer uses.
    x = torch.arange(h * w)
    assert torch.equal(pdispatch._tile_major(x, h, w, tile), x[torch.from_numpy(perm)])
    with pytest.raises(ValueError, match="multiple"):
        ppacket.tiled_ray_order(h + 1, w, tile)


# scene name -> (ray seed, ray bound): the ray sets of tests/test_torch_trace.py.
_CASES = {"cube": (2, 4.0), "soup300": (3, 8.0), "terrain20": (9, 14.0)}


@pytest.fixture(scope="module", params=sorted(_CASES))
def traced(request):
    js, jb, ps, pb = both_built(request.param)
    o, d = rays(2048, *_CASES[request.param])
    return {
        "scene": (ps, pb), "rays": (o, d),
        "packet": ppacket.traverse_packets(ps, pb, t_(o), t_(d), packet_size=256),
        "perray": ptrace.traverse(ps, pb, t_(o), t_(d)),
        "jax": jpacket.traverse_packets(
            js, jb, jnp.asarray(o), jnp.asarray(d), packet_size=256),
    }


def test_packets_bit_identical_to_port_perray(traced):
    for f in _FIELDS:
        assert torch.equal(getattr(traced["packet"], f), getattr(traced["perray"], f)), f
    assert bool(traced["packet"].hit.any()) and not bool(traced["packet"].hit.all())


def test_packets_vs_jax_packets(traced):
    ps, _ = traced["scene"]
    got, want = traced["packet"], traced["jax"]
    np.testing.assert_array_equal(n_(got.tri), np.asarray(want.tri))
    tri = ps.triangles
    scale = grazing_factor(n_(tri.a), n_(tri.b), n_(tri.c), traced["rays"][1],
                           np.asarray(want.tri))
    st = assert_hit_parity(got, want, uv_atol=1e-5, uv_scale=scale)
    assert st["tri_ties"] == 0


@pytest.mark.parametrize("packet_size", [128, 1024])
def test_serial_equals_lockstep_whatever_the_packet_size(traced, packet_size):
    ps, pb = traced["scene"]
    o, d = (t_(x) for x in traced["rays"])
    lock = ppacket.traverse_packets(ps, pb, o, d, packet_size=packet_size)
    serial = ppacket.traverse_packets(ps, pb, o, d, packet_size=packet_size, serial=True)
    for f in _FIELDS:
        assert torch.equal(getattr(serial, f), getattr(lock, f)), f
        assert torch.equal(getattr(lock, f), getattr(traced["perray"], f)), f


def test_packet_through_trace_rays_with_ragged_batch():
    _, _, ps, pb = both_built("soup300")
    o, d = (t_(x) for x in rays(1500, seed=13))  # padded to two packets of 1024
    got = pdispatch.trace_rays(ps, pb, o, d, impl="packet")
    want = ptrace.traverse(ps, pb, o, d)
    assert got.t.shape == (1500,)
    for f in _FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    # The packet engine ignores t_init and the any-hit threshold, as in JAX.
    seeded = pdispatch.trace_rays(
        ps, pb, o, d, impl="packet", t_init=torch.zeros(1500),
        anyhit_thresh=torch.full((1500,), 5.0))
    assert torch.equal(seeded.t, want.t)
    assert torch.equal(
        pdispatch.occluded(ps, pb, o, d, impl="packet"),
        pdispatch.occluded(ps, pb, o, d, impl="perray"))
    with pytest.raises(ValueError, match="not divisible"):
        ppacket.traverse_packets(ps, pb, o, d, packet_size=1024)
