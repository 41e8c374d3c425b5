"""Hygiene of the PyTorch port: it imports none of JAX or the JAX package, it
runs on the card unless asked for the CPU, and its kernel wrapper takes the
plain version only because a tensor lies on the CPU."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import unitysimpleraytracing_tpu_torch as pt
from unitysimpleraytracing_tpu_torch.ops import trace_bvh4 as pt4
from unitysimpleraytracing_tpu_torch.utils.device import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))



def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=300,
    )


def test_port_imports_no_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "import unitysimpleraytracing_tpu_torch as pt\n"
        "for m in pkgutil.walk_packages(pt.__path__, pt.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'unitysimpleraytracing_tpu')]\n"
        "assert not bad, bad\n"
        "assert 'unitysimpleraytracing_tpu_torch.cli' in sys.modules\n"
        "assert 'triton' not in sys.modules\n"
        "print('clean')\n"
    )
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def test_sources_name_no_jax_import():
    pkg = os.path.join(ROOT, "unitysimpleraytracing_tpu_torch")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(pkg):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        for line in open(path, encoding="utf-8"):
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1].split(".")[0]
                assert mod not in ("jax", "jaxlib", "flax", "unitysimpleraytracing_tpu"), (
                    path, s)


def test_default_device_is_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device does not raise here")
    mesh = pt.cube_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.build_scene(mesh)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.make_camera(eye=(1, 1, 1), target=(0, 0, 0), width=8, height=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.solid_texture()
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.texture_from_array(np.zeros((2, 2, 3), np.uint8))
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_cli_default_device_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device does not raise here")
    obj = tmp_path / "t.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\nf 1 2 3\nf 1 2 4\n")
    from unitysimpleraytracing_tpu_torch import cli

    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([str(obj), str(tmp_path / "o.png")])
    assert not (tmp_path / "o.png").exists()


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py runs there")
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_wrapper_on_cpu_takes_plain_version_and_counts_no_launch():
    scene = pt.build_scene(pt.cube_mesh(size=2.0), device="cpu")
    bvh = pt.build_bvh(scene, builder="karras")
    table = pt4.prepare_tables4(scene, bvh)
    rng = np.random.default_rng(0)
    o = torch.from_numpy(rng.uniform(-4, 4, size=(256, 3)).astype(np.float32))
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=1, keepdims=True))
    before = pt4.traverse_bvh4.launches
    got = pt4.traverse_bvh4(table, o, d)
    want = pt4.traverse_bvh4_plain(table, o, d)
    assert pt4.traverse_bvh4.launches == before == 0
    for f in ("t", "tri", "u", "v"):
        assert torch.equal(getattr(got, f), getattr(want, f))
    assert bool(got.hit.any())


def test_kernel_source_and_build_recipe_are_in_the_package():
    from unitysimpleraytracing_tpu_torch.utils import kernel_build

    src = os.path.join(kernel_build.CSRC_DIR, pt4.KERNEL_NAME + ".cu")
    text = open(src, encoding="utf-8").read()
    assert "__global__" in text and 'extern "C" int trace_bvh4_launch' in text
    assert "arch=compute_90a,code=sm_90a" in " ".join(kernel_build.NVCC_FLAGS)
    assert "-fmad=false" in kernel_build.NVCC_FLAGS
    assert "--use_fast_math" not in kernel_build.NVCC_FLAGS
    path = kernel_build.library_path(pt4.KERNEL_NAME)
    assert os.path.dirname(path) == os.path.join(ROOT, "build")
    assert path == kernel_build.library_path(pt4.KERNEL_NAME)  # keyed by content
