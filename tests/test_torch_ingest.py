"""Ingest parity of the PyTorch port against the JAX package: constants,
host meshes byte-identical, scene arrays bit-identical, PNG codec."""
import os

import numpy as np
import pytest
import torch

import unitysimpleraytracing_tpu as rt
import unitysimpleraytracing_tpu_torch as pt
from unitysimpleraytracing_tpu.core import morton as jmorton
from unitysimpleraytracing_tpu.io import png as jpng
from unitysimpleraytracing_tpu_torch.core import morton as pmorton
from unitysimpleraytracing_tpu_torch.io import png as ppng

from _torch_common import CPU, assert_fields_same_bits, assert_same_bits, both_scenes

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

_CONSTANTS = [
    "SUBLANE", "LANE", "VREG", "RADIX_BITS", "NUM_BUCKETS", "KEY_BITS",
    "NUM_PASSES", "SORT_BLOCK", "TRAVERSAL_STACK_DEPTH", "NULL_INDEX",
    "KEY_PADDING", "MAX_FLOAT", "PARITY_SCENE_BOUND", "AABB_INFLATION",
    "MORTON_BITS_PER_AXIS", "MORTON_GRID",
]


@pytest.mark.parametrize("name", _CONSTANTS)
def test_constants_equal(name):
    assert getattr(pt.constants, name) == getattr(rt.constants, name)


@pytest.mark.parametrize("n", [1, 12, 1024, 1025, 260642])
def test_pad_count_equal(n):
    assert pt.constants.pad_count(n) == rt.constants.pad_count(n)
    assert pt.constants.pad_count(n, 256) == rt.constants.pad_count(n, 256)


def _assert_mesh_bytes(got, want):
    for f in ("positions", "uvs", "normals"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and g.shape == w.shape, f
        assert g.tobytes() == w.tobytes(), f


_MESHES = {
    "cube": lambda m: m.cube_mesh(size=2.0, center=(0.5, -1.0, 2.0)),
    "terrain": lambda m: m.terrain_mesh(res=31, size=30.0, amplitude=5.0, seed=3),
    "soup": lambda m: m.random_triangle_soup(300, seed=11, bound=7.0, tri_size=0.8),
    "subdivide": lambda m: m.subdivide_mesh(m.cube_mesh(size=2.0), levels=2),
    "subdivide_displace": lambda m: m.subdivide_mesh(
        m.terrain_mesh(res=9, size=8.0, amplitude=1.0, seed=1), levels=1,
        displace=0.1, freq=2.0,
    ),
}


@pytest.mark.parametrize("name", sorted(_MESHES))
def test_procedural_meshes_byte_identical(name):
    _assert_mesh_bytes(_MESHES[name](pt), _MESHES[name](rt))


_OBJ = """# quad + triangle, with and without normals/uvs, negative indices
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0.5
v 2 2 2
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
f 1/1/1 2/2/1 3/3/1 4/4/1
f 1 2 5
f -1//1 -2//1 -5//1
"""


@pytest.mark.parametrize("flip_x", [False, True])
def test_load_obj_byte_identical(tmp_path, flip_x):
    path = tmp_path / "mesh.obj"
    path.write_text(_OBJ)
    want = rt.load_obj(str(path), flip_x=flip_x, backend="python")
    got = pt.load_obj(str(path), flip_x=flip_x)
    assert got.num_triangles == 4
    _assert_mesh_bytes(got, want)


def test_load_obj_native_backend_not_ported(tmp_path):
    """The native backend, once unported, is now the port's C++ parser: the
    same bytes as the Python parser (and the JAX package's); an unknown
    backend still raises."""
    path = tmp_path / "mesh.obj"
    path.write_text(_OBJ)
    got = pt.load_obj(str(path), backend="native")
    _assert_mesh_bytes(got, rt.load_obj(str(path), backend="python"))
    _assert_mesh_bytes(got, pt.load_obj(str(path), backend="python"))
    with pytest.raises(ValueError):
        pt.load_obj(str(path), backend="bogus")


def test_morton_codes_bit_identical():
    rng = np.random.default_rng(5)
    p = rng.uniform(-0.1, 1.1, size=(4096, 3)).astype(np.float32)
    p[:8] = [[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [1, 0, 0], [0, 1, 0],
             [0, 0, 1], [0.999, 0.001, 0.5], [1023 / 1024, 1 / 1024, 0]]
    want = np.asarray(jmorton.morton_from_points(p))
    got = pmorton.morton_from_points(torch.from_numpy(p))
    assert_same_bits(got, want, "morton")
    v = np.arange(1024, dtype=np.uint32)
    assert_same_bits(
        pmorton.expand_bits(torch.from_numpy(v.astype(np.int64))),
        np.asarray(jmorton.expand_bits(v)), "expand_bits",
    )


@pytest.mark.parametrize(
    "name", ["cube", "terrain48", "soup300", "soup300_dups"]
)
def test_build_scene_bit_identical(name):
    js, ps = both_scenes(name)
    assert ps.morton.dtype == torch.int64 and ps.tri_index.dtype == torch.int32
    assert_fields_same_bits(ps, js)


@pytest.mark.parametrize("name", ["cube", "terrain48", "soup300"])
def test_build_scene_parity_bound_bit_identical(name):
    from _torch_common import SCENES

    make, _ = SCENES[name]
    bound = rt.constants.PARITY_SCENE_BOUND
    js = rt.build_scene(make(rt), scene_bound=bound)
    ps = pt.build_scene(make(pt), scene_bound=bound, device=CPU)
    assert_fields_same_bits(ps, js)


def test_build_scene_pad_multiple():
    js = rt.build_scene(rt.cube_mesh(), pad_multiple=256)
    ps = pt.build_scene(pt.cube_mesh(), pad_multiple=256, device=CPU)
    assert ps.capacity == js.capacity == 256
    assert_fields_same_bits(ps, js)


@pytest.mark.parametrize("channels", [3, 4])
def test_png_round_trip(tmp_path, channels):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, size=(37, 53, channels), dtype=np.uint8)
    path = str(tmp_path / "img.png")
    ppng.write_png(path, img)
    np.testing.assert_array_equal(ppng.read_png(path), img)
    np.testing.assert_array_equal(ppng._read_png_pure(path), img)
    np.testing.assert_array_equal(jpng.read_png(path), img)
    # Float input rounds like the JAX writer.
    fimg = rng.uniform(-0.1, 1.1, size=(9, 7, channels)).astype(np.float32)
    ppng.write_png(path, fimg)
    jpath = str(tmp_path / "jimg.png")
    jpng.write_png(jpath, fimg)
    np.testing.assert_array_equal(ppng.read_png(path), jpng.read_png(jpath))


@pytest.mark.parametrize("name", ["cube_128x96.png", "terrain_shadow_128x96.png"])
def test_read_golden_png_equal(name):
    path = os.path.join(GOLDEN, name)
    want = jpng.read_png(path)
    np.testing.assert_array_equal(ppng.read_png(path), want)
    np.testing.assert_array_equal(ppng._read_png_pure(path), want)
