"""The port's C++ bridge (``unitysimpleraytracing_tpu_torch/native``): its OBJ
parser against its Python parser and the JAX package's C++ parser, bit for
bit, and its PNG unfilter against the pure-Python loops on every filter type.
The sources are built with ``g++`` into the git-ignored ``build/``."""
import os
import struct
import zlib

import numpy as np
import pytest

import unitysimpleraytracing_tpu_torch as pt
from unitysimpleraytracing_tpu import native as jnative
from unitysimpleraytracing_tpu.core import mesh as jmesh
from unitysimpleraytracing_tpu_torch import native
from unitysimpleraytracing_tpu_torch.io import png as ppng
from unitysimpleraytracing_tpu_torch.utils import kernel_build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

OBJS = {
    # Quad and pentagon fans, full v/vt/vn corners.
    "fans": "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0.5 1.5 0.25\n"
            "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nvn 0 0 1\nvn 0 1 0\n"
            "f 1/1/1 2/2/1 3/3/1 4/4/1\nf 1/1/2 2/2/2 3/3/2 5/4/2 4/4/2\n",
    # Negative (relative) indices, and corners without vt or vn.
    "negative_and_missing": "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
                            "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
                            "f 1/1 2/2 3/3 4/4\nf -4 -3 -2\nf -1/-1 -2/-2 -4/-4\n",
    # No vt or vn at all (flat normals), v//vn corners, comments, blank lines,
    # CRLF, and decimals that need careful rounding.
    "normals_only": "# comment\r\nv 0.1 0.2 0.3\r\nv 1.0000001 -2.5e-3 3.4028234663852886e38\r\n"
                    "v -0.30000001192092896 7 1e-7\r\n\r\nvn 0 0 -1\r\nf 1//1 2//1 3//1\r\n"
                    "f 3 2 1\r\n",
}


def _write(tmp_path, name):
    path = tmp_path / f"{name}.obj"
    path.write_bytes(OBJS[name].encode())
    return str(path)


def _bytes(m):
    return [a.dtype.str + a.tobytes().hex() for a in (m.positions, m.uvs, m.normals)]


def test_native_library_builds_into_build_not_the_package():
    assert native.available(), native.build_error()
    lib = native.library_path()
    assert os.path.dirname(lib) == os.path.join(ROOT, "build") == kernel_build.BUILD_DIR
    assert os.path.exists(lib) and os.path.basename(lib).startswith("libingest_torch_")
    pkg = os.path.dirname(native.__file__)
    assert not [f for f in os.listdir(pkg) if f.endswith(".so")]
    assert native.build_error() is None


@pytest.mark.parametrize("name", sorted(OBJS))
@pytest.mark.parametrize("flip_x", [False, True])
def test_native_equals_python_and_jax_native(tmp_path, name, flip_x):
    path = _write(tmp_path, name)
    got = pt.load_obj(path, flip_x=flip_x, backend="native")
    assert _bytes(got) == _bytes(pt.load_obj(path, flip_x=flip_x, backend="python"))
    assert _bytes(got) == _bytes(pt.load_obj(path, flip_x=flip_x))  # "auto" = native
    assert _bytes(got) == _bytes(jmesh.load_obj(path, flip_x=flip_x, backend="python"))
    if jnative.available():
        assert _bytes(got) == _bytes(jmesh.load_obj(path, flip_x=flip_x, backend="native"))
    raw = native.load_obj_native(path)
    want = jnative.load_obj_native(path) if jnative.available() else None
    if want is not None:
        for g, w in zip(raw, want):
            assert np.asarray(g).tobytes() == np.asarray(w).tobytes()


def test_native_fans_and_relative_indices_counts(tmp_path):
    assert pt.load_obj(_write(tmp_path, "fans"), backend="native").num_triangles == 2 + 3
    m = pt.load_obj(_write(tmp_path, "negative_and_missing"), backend="native")
    assert m.num_triangles == 4
    assert np.array_equal(m.positions[2], m.positions[0][[0, 1, 2]])  # -4 -3 -2 = 1 2 3


def test_native_missing_file_raises():
    with pytest.raises(RuntimeError):
        native.load_obj_native("/nonexistent/file.obj")
    with pytest.raises(RuntimeError):
        pt.load_obj("/nonexistent/file.obj", backend="native")


def test_native_backend_raises_when_the_library_cannot_build(tmp_path, monkeypatch):
    path = _write(tmp_path, "fans")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    monkeypatch.setattr(native, "library_path", lambda: str(tmp_path / "build" / "lib.so"))
    monkeypatch.setattr(native, "compiler", lambda: None)
    assert not native.available() and "g++" in native.build_error()
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        pt.load_obj(path, backend="native")
    with pytest.raises(RuntimeError):
        native.png_unfilter_native(b"\x00" * 8, 1, 7, 1)
    # "auto" takes the Python parser then, with the same arrays.
    monkeypatch.undo()
    assert _bytes(pt.load_obj(path)) == _bytes(pt.load_obj(path, backend="python"))


def _filter_rows(img: np.ndarray, ftypes, bpp: int) -> bytes:
    """Apply PNG filter ftypes[row % len] to each row of an (h, stride) image."""
    h, stride = img.shape
    out = bytearray()
    prev = np.zeros(stride, np.int32)
    for row in range(h):
        cur = img[row].astype(np.int32)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        f = ftypes[row % len(ftypes)]
        if f == 0:
            enc = cur
        elif f == 1:
            enc = cur - left
        elif f == 2:
            enc = cur - prev
        elif f == 3:
            enc = cur - ((left + prev) >> 1)
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
            enc = cur - pred
        out += bytes([f]) + (enc & 0xFF).astype(np.uint8).tobytes()
        prev = cur
    return bytes(out)


def _png(path, img, color_type, ftypes, palette=None):
    h, w = img.shape[:2]
    bpp = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    raw = _filter_rows(img.reshape(h, w * bpp), ftypes, bpp)

    def chunk(ctype, payload):
        return (struct.pack(">I", len(payload)) + ctype + payload
                + struct.pack(">I", zlib.crc32(ctype + payload) & 0xFFFFFFFF))

    data = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                                             0, 0, 0))
    if palette is not None:
        data += chunk(b"PLTE", palette.tobytes())
    data += chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")
    path.write_bytes(data)
    return str(path)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("color_type", [0, 2, 3, 4, 6])
def test_png_unfilter_native_equals_pure_on_every_filter(tmp_path, ftype, color_type):
    rng = np.random.default_rng(10 * ftype + color_type)
    h, w = 7, 13
    bpp = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    img = rng.integers(0, 256, size=(h, w, bpp), dtype=np.uint8)
    palette = None
    if color_type == 3:
        img = rng.integers(0, 16, size=(h, w, 1), dtype=np.uint8)
        palette = rng.integers(0, 256, size=(16, 3), dtype=np.uint8)
    # Row 0 with the chosen filter, later rows cycling through all five.
    path = _png(tmp_path / "t.png", img, color_type, [ftype, 0, 1, 2, 3, 4], palette)
    with open(path, "rb") as f:
        data = f.read()
    want = img if palette is None else palette[img[:, :, 0]]
    pure = ppng._decode(data, path, ppng._unfilter_python)
    fast = ppng._decode(data, path, native.png_unfilter_native)
    assert pure.dtype == fast.dtype == np.uint8
    assert np.array_equal(pure, want) and np.array_equal(fast, want)
    assert np.array_equal(ppng.read_png(path), want)   # native first
    assert np.array_equal(ppng._read_png_pure(path), want)
    raw = zlib.decompress(data[data.index(b"IDAT") + 4: data.index(b"IEND") - 8])
    direct = native.png_unfilter_native(raw, h, w * bpp, bpp)
    assert np.array_equal(direct, ppng._unfilter_python(raw, h, w * bpp, bpp))


def test_png_unfilter_native_rejects_a_bad_filter_and_short_data():
    raw = bytes([5]) + bytes(6)
    with pytest.raises(RuntimeError, match="row 0"):
        native.png_unfilter_native(raw, 1, 6, 3)
    with pytest.raises(ValueError):
        ppng._unfilter_python(raw, 1, 6, 3)
    with pytest.raises(ValueError):
        native.png_unfilter_native(raw, 2, 6, 3)


def test_read_png_round_trips_the_writer_and_reads_the_goldens(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, size=(9, 11, 4), dtype=np.uint8)
    ppng.write_png(str(tmp_path / "w.png"), img)
    assert np.array_equal(ppng.read_png(str(tmp_path / "w.png")), img)
    golden = os.path.join(ROOT, "tests", "golden", "cube_128x96.png")
    assert np.array_equal(ppng.read_png(golden), ppng._read_png_pure(golden))
