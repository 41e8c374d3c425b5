"""Checkpoints of the port (io/checkpoint): the same ``.npz`` keys and format
version as the JAX package's, so a file written by either package loads in
the other, one tree or chunked; and the CLI's ``--bvh-cache``, which saves
on the first run and restores on the next, for one tree and for chunks."""
import os

import numpy as np
import pytest
import torch

import unitysimpleraytracing_tpu as rt
import unitysimpleraytracing_tpu_torch as pt
from unitysimpleraytracing_tpu.io import checkpoint as jckpt
from unitysimpleraytracing_tpu_torch import cli as pcli
from unitysimpleraytracing_tpu_torch.io import checkpoint as pckpt
from unitysimpleraytracing_tpu_torch.io.png import read_png

from _torch_common import CPU, assert_fields_same_bits, assert_same_bits, rays, t_


def _terrain(m):
    return m.terrain_mesh(res=16, size=16.0, amplitude=3.0, seed=1)


@pytest.fixture(scope="module")
def built():
    """JAX and port scenes of one terrain, their single trees and their
    chunked builds (4 chunks of 128), BVH4 and binary records."""
    js, ps = rt.build_scene(_terrain(rt)), pt.build_scene(_terrain(pt), device=CPU)
    out = {"js": js, "ps": ps,
           "jb": rt.build_bvh(js, builder="karras"), "pb": pt.build_bvh(ps, builder="karras")}
    for fmt in ("bvh4", "bvh2"):
        out["jc", fmt] = rt.build_bvh_chunked(js, chunk_capacity=128, builder="karras",
                                              record_format=fmt)
        out["pc", fmt] = pt.build_bvh_chunked(ps, chunk_capacity=128, builder="karras",
                                              record_format=fmt)
    return out


def _same_chunked(got, want):
    assert_fields_same_bits(got.sscene, want.sscene)
    assert_fields_same_bits(got.bvhs, want.bvhs)
    assert_same_bits(got.tables, want.tables, "tables")


def test_checkpoint_keys_are_the_jax_package_s(built, tmp_path):
    pckpt.save_checkpoint(str(tmp_path / "p.npz"), built["ps"], built["pb"])
    jckpt.save_checkpoint(str(tmp_path / "j.npz"), built["js"], built["jb"])
    pckpt.save_chunked_checkpoint(str(tmp_path / "pc.npz"), built["pc", "bvh4"])
    jckpt.save_chunked_checkpoint(str(tmp_path / "jc.npz"), built["jc", "bvh4"])
    for a, b in (("p", "j"), ("pc", "jc")):
        with np.load(tmp_path / f"{a}.npz") as za, np.load(tmp_path / f"{b}.npz") as zb:
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                assert za[k].dtype == zb[k].dtype and za[k].shape == zb[k].shape, k
    with np.load(tmp_path / "pc.npz") as z:
        assert bytes(z["meta/kind"]) == b"chunked" and int(z["meta/version"]) == 2
        assert z["sscene/morton"].dtype == np.uint32


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_single_tree_checkpoint_crosses_packages(built, tmp_path, writer):
    path = str(tmp_path / "tree.npz")
    if writer == "port":
        pckpt.save_checkpoint(path, built["ps"], built["pb"])
        js, jb = jckpt.load_checkpoint(path)
        assert_fields_same_bits(built["ps"], js)
        assert_fields_same_bits(built["pb"], jb)
    else:
        jckpt.save_checkpoint(path, built["js"], built["jb"])
    ps, pb = pckpt.load_checkpoint(path, device=CPU)
    assert ps.morton.dtype == torch.int64
    assert_fields_same_bits(ps, built["js"])
    assert_fields_same_bits(pb, built["jb"])
    # The restored tree traces as the built one.
    a = pt.render_hits(ps, pb, pt.make_camera(eye=(12, 10, 15), target=(0, 0, 0),
                                              width=32, height=32, device=CPU))
    b = pt.render_hits(built["ps"], built["pb"], pt.make_camera(
        eye=(12, 10, 15), target=(0, 0, 0), width=32, height=32, device=CPU))
    assert torch.equal(a.t, b.t) and torch.equal(a.tri, b.tri)


@pytest.mark.parametrize("record_format", ["bvh4", "bvh2"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_chunked_checkpoint_crosses_packages(built, tmp_path, writer, record_format):
    path = str(tmp_path / "chunks.npz")
    if writer == "port":
        pckpt.save_chunked_checkpoint(path, built["pc", record_format])
        _same_chunked(built["pc", record_format], jckpt.load_chunked_checkpoint(path))
    else:
        jckpt.save_chunked_checkpoint(path, built["jc", record_format])
    got = pckpt.load_chunked_checkpoint(path, device=CPU)
    _same_chunked(got, built["jc", record_format])
    o, d = (t_(x) for x in rays(512, 6, bound=10.0))
    a = pt.trace_chunked(got, o, d)
    b = pt.trace_chunked(built["pc", record_format], o, d)
    for f in ("t", "tri", "u", "v"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("pack", [2, 4])
def test_jax_packed_binary_chunk_table_is_read_as_flat_records(built, tmp_path, pack):
    """The JAX package may store binary chunk records ``pack`` to a row: the
    same bytes as (S, cap, 32).  A pack=2 table is 64 wide, like BVH4
    records; the loader tells them apart by chunk 0's re-packed records."""
    jc = built["jc", "bvh2"]
    S, cap = jc.num_chunks, jc.capacity
    packed = jc.replace(tables=jc.tables.reshape(S, cap // pack, 32 * pack))
    path = str(tmp_path / "packed.npz")
    jckpt.save_chunked_checkpoint(path, packed)
    got = pckpt.load_chunked_checkpoint(path, device=CPU)
    assert tuple(got.tables.shape) == (S, cap, 32)
    _same_chunked(got, jc)


def test_a_table_that_matches_its_trees_in_no_reading_raises(built, tmp_path):
    pc = built["pc", "bvh4"]
    bad = pc.tables.clone()
    bad[0, 0, 0] += 1.0
    path = str(tmp_path / "bad.npz")
    pckpt.save_chunked_checkpoint(path, pc.replace(tables=bad))
    with pytest.raises(ValueError, match="matches neither"):
        pckpt.load_chunked_checkpoint(path, device=CPU)


def test_loading_the_wrong_kind_raises(built, tmp_path):
    one, many = str(tmp_path / "one.npz"), str(tmp_path / "many.npz")
    pckpt.save_checkpoint(one, built["ps"], built["pb"])
    pckpt.save_chunked_checkpoint(many, built["pc", "bvh4"])
    with pytest.raises(ValueError, match="load_chunked_checkpoint"):
        pckpt.load_checkpoint(many, device=CPU)
    with pytest.raises(ValueError, match="load_checkpoint"):
        pckpt.load_chunked_checkpoint(one, device=CPU)


_OBJ_RES = 12


def _terrain_obj(path):
    """A terrain mesh as an OBJ file (positions and faces only)."""
    mesh = pt.terrain_mesh(res=_OBJ_RES, size=12.0, amplitude=2.0, seed=2)
    pos = mesh.positions.reshape(-1, 3)
    lines = [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in pos]
    lines += [f"f {3 * i + 1} {3 * i + 2} {3 * i + 3}" for i in range(len(pos) // 3)]
    path.write_text("\n".join(lines) + "\n")
    return mesh.num_triangles


@pytest.mark.parametrize("chunked", [False, True])
def test_cli_bvh_cache_saves_then_restores(tmp_path, capsys, monkeypatch, chunked):
    """First run builds and saves the checkpoint, the second restores it and
    writes the same image.  ``chunked`` lowers the CLI's switch point below
    the mesh so the chunked branch runs at this size."""
    obj = tmp_path / "terrain.obj"
    n = _terrain_obj(obj)
    if chunked:
        monkeypatch.setattr(pcli, "CHUNKED_ABOVE", n // 3)
    cache = tmp_path / "bvh.npz"
    args = ["--device", "cpu", "--width", "64", "--height", "64", "--shadows",
            "--bvh-cache", str(cache)]
    pcli.main([str(obj), str(tmp_path / "a.png"), *args])
    first = capsys.readouterr().out
    assert os.path.exists(cache) and "saved" in first
    assert ("chunked BVH built" in first) == chunked
    pcli.main([str(obj), str(tmp_path / "b.png"), *args])
    second = capsys.readouterr().out
    assert "restored" in second and "saved" not in second
    with np.load(cache) as z:
        assert ("meta/kind" in z.files) == chunked
    a, b = read_png(str(tmp_path / "a.png")), read_png(str(tmp_path / "b.png"))
    assert a.shape == (64, 64, 4) and np.array_equal(a, b)
    assert len(np.unique(a.reshape(-1, 4), axis=0)) >= 4  # not a flat fill
