"""Native host components (C++ via ctypes): the OBJ parser and PNG unfilter.

Counterpart of ``unitysimpleraytracing_tpu/native``, same API (`available`,
`build_error`, `load_obj_native`, `png_unfilter_native`) over the port's own
copies of its sources: the OBJ data loader (``ingest.cpp``) and the PNG
scanline unfilter (``image.cpp``).  They are compiled with the system ``g++``
on first use into one shared library under ``build/`` at the repository root
(git-ignored), named by a hash of the sources and flags so a changed source
rebuilds, and loaded through ``ctypes``.  Nothing is compiled when the module
is imported.  ``core/mesh.load_obj(backend="native")`` raises when the
library cannot be built; ``"auto"`` and ``io/png.read_png`` then take the
pure-Python code, which gives the same arrays.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

from unitysimpleraytracing_tpu_torch.utils.kernel_build import BUILD_DIR

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("ingest.cpp", "image.cpp")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_error: str | None = None


class _ObjMesh(ctypes.Structure):
    _fields_ = [
        ("pos", ctypes.POINTER(ctypes.c_float)),
        ("uv", ctypes.POINTER(ctypes.c_float)),
        ("nrm", ctypes.POINTER(ctypes.c_float)),
        ("n_tris", ctypes.c_long),
        ("has_uv", ctypes.c_int),
        ("has_nrm", ctypes.c_int),
    ]


def library_path() -> str:
    """Where the sources build to, keyed by their bytes and the flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(_DIR, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libingest_torch_{h.hexdigest()[:16]}.so")


def compiler() -> str | None:
    """The C++ compiler the build uses: ``g++`` on ``PATH``."""
    return shutil.which("g++")


def _build() -> str | None:
    """Compile the sources unless their library exists; returns an error
    string on failure.  The library is written under a temporary name and
    renamed, so processes building at once never load half a file."""
    out = library_path()
    if os.path.exists(out):
        return None
    cxx = compiler()
    if cxx is None:
        return "native build failed: g++ not found on PATH"
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [cxx, *CXX_FLAGS, *(os.path.join(_DIR, s) for s in SOURCES), "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"native build failed: {e}"
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        return f"native build failed: {proc.stderr[-500:]}"
    os.replace(tmp, out)
    return None


def _load() -> ctypes.CDLL | None:
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        err = _build()
        if err is not None:
            _build_error = err
            return None
        lib = ctypes.CDLL(library_path())
        lib.obj_load.restype = ctypes.POINTER(_ObjMesh)
        lib.obj_load.argtypes = [ctypes.c_char_p]
        lib.obj_free.argtypes = [ctypes.POINTER(_ObjMesh)]
        lib.obj_free.restype = None
        lib.obj_last_error.restype = ctypes.c_char_p
        lib.obj_last_error.argtypes = []
        lib.png_unfilter.restype = ctypes.c_long
        lib.png_unfilter.argtypes = [
            ctypes.POINTER(ctypes.c_ubyte), ctypes.c_long, ctypes.c_long,
            ctypes.c_long, ctypes.POINTER(ctypes.c_ubyte),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    """True if the native library is (or can be) built and loaded."""
    return _load() is not None


def build_error() -> str | None:
    _load()
    return _build_error


def load_obj_native(path: str):
    """Parse an OBJ with the C++ loader.

    Returns (pos (T,3,3) f32, uv (T,3,2) f32, nrm (T,3,3) f32, has_nrm bool).
    Raises RuntimeError if the library is unavailable or parsing fails.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(_build_error or "native library unavailable")
    m = lib.obj_load(os.fsencode(path))
    if not m:
        raise RuntimeError(lib.obj_last_error().decode())
    try:
        T = m.contents.n_tris
        pos = np.ctypeslib.as_array(m.contents.pos, shape=(T, 3, 3)).copy()
        uv = np.ctypeslib.as_array(m.contents.uv, shape=(T, 3, 2)).copy()
        nrm = np.ctypeslib.as_array(m.contents.nrm, shape=(T, 3, 3)).copy()
        has_nrm = bool(m.contents.has_nrm)
    finally:
        lib.obj_free(m)
    return pos, uv, nrm, has_nrm


def png_unfilter_native(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Unfilter PNG scanlines with the C++ fast path.

    ``raw`` is the zlib-decompressed stream (h rows of 1 filter byte +
    ``stride`` data bytes); returns (h, stride) uint8.  Raises RuntimeError
    if the library is unavailable or a filter type is invalid, ValueError if
    ``raw`` is shorter than the rows it must hold.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(_build_error or "native library unavailable")
    if len(raw) < h * (stride + 1):
        raise ValueError(f"PNG data holds {len(raw)} bytes, {h} rows need {h * (stride + 1)}")
    src = np.frombuffer(raw, np.uint8, h * (stride + 1))
    out = np.empty((h, stride), np.uint8)
    rc = lib.png_unfilter(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        h, stride, bpp,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
    )
    if rc:
        raise RuntimeError(f"bad PNG filter type at row {rc - 1}")
    return out
