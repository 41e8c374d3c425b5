"""The port's multi-device engines against the JAX package's, on one input.

The JAX package's three tp engines (`render_hits_sharded`, `_ring`,
`_shuffle`) run once each at (dp, tp) = (2, 4) on the 8-virtual-device CPU
mesh of tests/conftest.py, and its pipeline (`render_frames_pipelined`) once
on 2 of those devices; the port runs the same numpy inputs on an 8-rank gloo
group (tests/_torch_dist_worker.py, suite ``vs_jax``; the pipeline on ranks 0
and 1).  Input: tests/test_dist.py's 220-triangle soup with 512 rays (seed
3), and tests/test_pipeline_pp.py's 160-triangle, 4-frame deformation with
256 rays (seed 11), its positions computed once in numpy.

Tolerance, on the whole payload tuple: identical hit masks; t within 4e-6
relative plus 1e-5 times `utils/parity.grazing_factor`, the bound of
test_torch_trace.py::test_ray_triangle_random_parity (XLA:CPU fuses
multiply-adds that the port keeps apart, and t, u, v are quotients by det);
another triangle only where t agrees within that bound (an exact-t tie); u,
v, uv and normal within 1e-5 times the grazing factor on hits where the
triangle agrees.  Misses carry shard-local triangle 0's attributes in both
packages, so the payload is compared on hits only.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import unitysimpleraytracing_tpu as rt
from unitysimpleraytracing_tpu.parallel import dist as jdist
from unitysimpleraytracing_tpu.parallel import pipeline_pp as jpp
from unitysimpleraytracing_tpu_torch.ops import dispatch as pdispatch
from unitysimpleraytracing_tpu_torch.utils.parity import MAX_FLOAT, grazing_factor

import _torch_dist_worker as W
from _torch_common import n_
from _torch_dist_worker import assemble, run_ranks

FIELDS = ("t", "tri", "u", "v", "uv", "normal")


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return run_ranks("vs_jax", 8, str(tmp_path_factory.mktemp("dist_vs_jax")))


@pytest.fixture(scope="module")
def soup220():
    scene = rt.build_scene(rt.random_triangle_soup(220, seed=3, bound=5.0, tri_size=1.0))
    o, d = (n_(x) for x in W.rays(512, 3))
    return scene, o, d


def assert_payload_parity(got: dict, want: dict, tris, d) -> int:
    """The file's tolerance (module docstring) on (t, tri, u, v[, uv,
    normal]); returns the number of exact-t ties."""
    a, b, c = tris
    jt, jtri = want["t"], want["tri"]
    hit = jt != MAX_FLOAT
    np.testing.assert_array_equal(got["t"] != MAX_FLOAT, hit, err_msg="hit masks differ")
    assert hit.sum() > 0
    scale = grazing_factor(a, b, c, d, jtri)
    bound = 4e-6 * np.abs(jt) + 1e-5 * scale
    assert np.all((np.abs(got["t"] - jt) <= bound)[hit]), "t outside the bound"
    same = hit & (got["tri"] == jtri)
    for f in FIELDS[2:]:
        if f not in want:
            continue
        err = np.abs(got[f] - want[f]).reshape(len(jt), -1).max(axis=1)
        assert np.all((err <= 1e-5 * scale)[same]), f
    return int((hit & ~same).sum())


@pytest.mark.parametrize("engine", ["sharded", "ring", "shuffle"])
def test_engine_matches_jax_engine(port, soup220, engine):
    scene, o, d = soup220
    mesh = jdist.make_mesh(dp=2, tp=4)
    ss = jdist.partition_scene(scene, 4)
    fn = getattr(jdist, f"render_hits_{engine}")
    want = dict(zip(FIELDS, (np.asarray(x) for x in fn(ss, jnp.asarray(o), jnp.asarray(d), mesh))))
    got = assemble(port, engine)
    t = scene.triangles
    tris = tuple(np.asarray(x) for x in (t.a, t.b, t.c))
    assert_payload_parity(got, want, tris, d)


def test_pipeline_matches_jax_pipeline(port):
    """The pipelined stream, frame by frame, against JAX's on the same
    positions (4 frames, 256 rays)."""
    got = {k.split("|")[1]: v for k, v in port[0].items() if k.startswith("pipeline|")}
    other = {k.split("|")[1]: v for k, v in port[1].items() if k.startswith("pipeline|")}
    for f in ("t", "tri", "u", "v"):  # both ranks return stage 1's stream
        np.testing.assert_array_equal(got[f].view(np.uint8), other[f].view(np.uint8))
    positions = got["positions"]
    scene = rt.build_scene(rt.random_triangle_soup(160, seed=11, bound=4.0, tri_size=1.0))
    t = scene.triangles
    base = np.stack([np.asarray(t.a), np.asarray(t.b), np.asarray(t.c)], axis=1)
    np.testing.assert_array_equal(positions[0][..., 0], base[..., 0])  # the same input
    o, d = (n_(x) for x in W.rays(256, 11, lo=-6.0, hi=6.0))
    h = jpp.render_frames_pipelined(scene, jnp.asarray(positions), jnp.asarray(o),
                                    jnp.asarray(d), jpp.make_pp_mesh())
    assert got["t"].shape == (4, 256)
    for i in range(4):
        want = {f: np.asarray(getattr(h, f))[i] for f in ("t", "tri", "u", "v")}
        frame = {f: got[f][i] for f in ("t", "tri", "u", "v")}
        tris = tuple(positions[i][:, k] for k in range(3))
        assert_payload_parity(frame, want, tris, d)


def test_pipeline_equals_serial_port_frames(port):
    """Bit for bit: the port's pipelined stream against its serial deform →
    build_bvh(builder="karras") → trace_rays of each frame."""
    got = {k.split("|")[1]: v for k, v in port[0].items() if k.startswith("pipeline|")}
    scene, positions, o, d = W.pipeline_input()
    for i in range(4):
        s2 = W.pt.deform_scene(scene, positions[i])
        h = pdispatch.trace_rays(s2, W.pt.build_bvh(s2, builder="karras"), o, d)
        for f in ("t", "tri", "u", "v"):
            np.testing.assert_array_equal(got[f][i].view(np.uint8), n_(getattr(h, f)).view(np.uint8))
    np.testing.assert_array_equal(got["positions"], n_(positions))
