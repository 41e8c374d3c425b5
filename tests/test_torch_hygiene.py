"""Hygiene of the PyTorch port: it imports none of JAX or the JAX package, it
runs on the card unless asked for the CPU, and its kernel wrappers take the
plain version only because a tensor lies on the CPU."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import unitysimpleraytracing_tpu_torch as pt
from unitysimpleraytracing_tpu_torch.ops import scan as pscan
from unitysimpleraytracing_tpu_torch.ops import sort as psort
from unitysimpleraytracing_tpu_torch.ops import sort_radix_cuda as pcu
from unitysimpleraytracing_tpu_torch.ops import trace_bvh2 as pt2
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
                assert mod not in ("jax", "jaxlib", "flax", "unitysimpleraytracing_tpu",
                                   "benchmarks", "bench"), (path, s)


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


def test_validator_default_device_is_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device does not raise here")
    from unitysimpleraytracing_tpu_torch.utils import validate

    keys = np.arange(1024, dtype=np.uint32)
    with pytest.raises(RuntimeError, match="CUDA"):
        validate.validate_sort_per_pass(keys, np.arange(1024, dtype=np.int32))
    validate.validate_sort_per_pass(keys, np.arange(1024, dtype=np.int32), device="cpu")


@pytest.mark.parametrize("wrapper", ["digit_histogram", "digit_rank", "exclusive_scan",
                                     "sort_key_val", "build_bvh", "digit_counts", "digit_pass"])
def test_sort_wrappers_on_cpu_take_plain_versions_and_count_no_launch(wrapper):
    rng = np.random.default_rng(0)
    keys = torch.from_numpy(rng.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.int64))
    vals = torch.arange(4096, dtype=torch.int32)
    hist_t = pcu.digit_histogram_plain(keys, 8)
    bases = pscan.exclusive_scan_plain(hist_t)
    if wrapper == "digit_histogram":
        assert torch.equal(pcu.digit_histogram(keys, 8), hist_t)
    elif wrapper == "digit_rank":
        assert torch.equal(pcu.digit_rank(keys, bases, 8), pcu.digit_rank_plain(keys, bases, 8))
    elif wrapper == "exclusive_scan":
        assert torch.equal(pscan.exclusive_scan(hist_t), bases)
    elif wrapper == "digit_counts":
        assert torch.equal(pcu.digit_counts(keys), pcu.digit_counts_plain(keys))
    elif wrapper == "digit_pass":
        counts = pscan.exclusive_scan_plain(pcu.digit_counts_plain(keys))
        got = pcu.digit_pass(keys, vals, counts, 8, observe=True)
        for g, w in zip(got, pcu.digit_pass_plain(keys, vals, counts, 8)):
            assert torch.equal(g, w)
    elif wrapper == "sort_key_val":
        got = psort.sort_key_val(keys, vals, impl="cuda")
        want = psort.sort_key_val(keys, vals, impl="torch")
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    else:
        scene = pt.build_scene(pt.cube_mesh(size=2.0), device="cpu")
        got = pt.build_bvh(scene, sort_impl="cuda", builder="karras")
        assert torch.equal(got.sorted_tri, pt.build_bvh(scene, builder="karras").sorted_tri)
    assert pcu.digit_histogram.launches == 0 and pcu.digit_rank.launches == 0
    assert pcu.digit_counts.launches == 0 and pcu.digit_pass.launches == 0
    assert pscan.exclusive_scan.launches == 0 and pscan.exclusive_scan.device_launches == 0


@pytest.mark.parametrize("name, entry_points", [
    (pcu.KERNEL_NAME, ["digit_histogram_launch", "digit_rank_launch", "digit_count_launch",
                       "digit_pass_launch"]),
    (pscan.KERNEL_NAME, ["scan_launch"]),
])
def test_sort_kernel_sources_and_build_recipe_are_in_the_package(name, entry_points):
    from unitysimpleraytracing_tpu_torch.utils import kernel_build

    text = open(os.path.join(kernel_build.CSRC_DIR, name + ".cu"), encoding="utf-8").read()
    assert "__global__" in text and "cudaGetLastError" in text
    for fn in entry_points:
        assert f'extern "C" int {fn}' in text
    for banned in ("cub::Device", "thrust::", "#include <torch", "#include <ATen"):
        assert banned not in text
    assert os.path.dirname(kernel_build.library_path(name)) == os.path.join(ROOT, "build")


def test_port_calls_no_library_stand_in_for_a_kernel():
    """The kernel modules' CUDA paths do not reach the PyTorch calls that
    compute the same functions (they appear in the plain versions only)."""
    import inspect

    for fn in (pcu.digit_histogram, pcu.digit_rank, pscan.exclusive_scan, pscan._scan_on_card,
               pcu._sort_pass, pcu.digit_counts, pcu.digit_pass, pcu.radix_sort_key_val_cuda,
               pcu._stream_scratch, pcu._sort_on_card):
        src = inspect.getsource(fn)
        for banned in ("bincount", "histc", "cumsum", "torch.sort", "argsort", "compile"):
            assert banned not in src, (fn.__name__, banned)


@pytest.mark.parametrize("module", ["ops.trace_packet", "ops.trace_bvh2", "ops.sah",
                                    "utils.profiling", "benchmarks.kernel_probe",
                                    "utils.visualize", "utils.debug", "utils.resilience",
                                    "utils.reference_impl", "native", "benchmarks.bench"])
def test_new_traversal_modules_import_no_jax(module):
    code = (
        "import sys, importlib\n"
        f"importlib.import_module('unitysimpleraytracing_tpu_torch.{module}')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'unitysimpleraytracing_tpu', 'triton')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def test_traverse_bvh2_on_a_cuda_tensor_has_no_path_to_the_plain_version():
    """Each wrapper calls its plain version in one place, under the test that
    the rays lie on the CPU; past it there is the shared launcher, which
    launches or raises, and no ``try`` that could swallow a failed build or
    launch."""
    import inspect

    def body_of(fn):
        src = inspect.getsource(fn)
        return src[src.index('"""', src.index('"""') + 3) + 3:]  # past the docstring

    for wrapper, plain in ((pt2.traverse_bvh2, "traverse_bvh2_plain"),
                           (pt4.traverse_bvh4, "traverse_bvh4_plain")):
        body = body_of(wrapper)
        assert body.count(plain) == 1, wrapper.__name__
        cpu_branch = body.index('if origins.device.type == "cpu":')
        assert cpu_branch < body.index(plain) < body.index("launch_traversal(")
        assert body.index("launch_traversal(") < body.index(".launches += 1")
    launcher = body_of(pt4.launch_traversal)
    assert 'if origins.device.type != "cuda":' in launcher
    assert "raise RuntimeError" in launcher and "_plain" not in launcher
    for body in (body_of(pt2.traverse_bvh2), body_of(pt4.traverse_bvh4), launcher):
        for banned in ("try:", "except", "compile", "torch.jit"):
            assert banned not in body, banned


def test_traverse_bvh2_on_cpu_takes_plain_version_and_counts_no_launch():
    scene = pt.build_scene(pt.cube_mesh(size=2.0), device="cpu")
    bvh = pt.build_bvh(scene, builder="karras")
    table = pt2.prepare_tables(scene, bvh)
    rng = np.random.default_rng(0)
    o = torch.from_numpy(rng.uniform(-4, 4, size=(256, 3)).astype(np.float32))
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=1, keepdims=True))
    got = pt2.traverse_bvh2(table, o, d)
    want = pt2.traverse_bvh2_plain(table, o, d)
    assert pt2.traverse_bvh2.launches == 0
    for f in ("t", "tri", "u", "v"):
        assert torch.equal(getattr(got, f), getattr(want, f))
    assert bool(got.hit.any())


def test_kernel2_source_is_listed_for_the_build_and_build_stays_ignored():
    from unitysimpleraytracing_tpu_torch.utils import kernel_build

    assert pt2.KERNEL_NAME == "trace_bvh2"
    text = open(os.path.join(kernel_build.CSRC_DIR, "trace_bvh2.cu"), encoding="utf-8").read()
    assert "__global__" in text and 'extern "C" int trace_bvh2_launch' in text
    assert "cudaGetLastError" in text and "__trap()" in text
    for banned in ("cub::", "thrust::", "#include <torch", "#include <ATen", "optix"):
        assert banned not in text
    assert os.path.dirname(kernel_build.library_path(pt2.KERNEL_NAME)) == os.path.join(ROOT, "build")
    # chip_smoke.py builds it with the others, all started together.
    smoke = open(os.path.join(ROOT, "chip_smoke.py"), encoding="utf-8").read()
    names = smoke[smoke.index("kernel_names = ("):smoke.index("started = {")]
    for mod in ("trace_bvh4", "trace_bvh2", "sort_radix_cuda", "scan", "kernel_probe"):
        assert f"{mod}.KERNEL_NAME" in names
    ignored = [ln.strip() for ln in open(os.path.join(ROOT, ".gitignore"), encoding="utf-8")]
    assert "build/" in ignored


# ---- the probes P1, P2 and the measurement path ---------------------------------


def test_probe_wrappers_on_cpu_take_plain_versions_and_count_no_launch():
    from unitysimpleraytracing_tpu_torch.benchmarks import kernel_probe as kp

    tab = kp.make_table(seed=0, device="cpu")
    for name in ("empty", "fetch_x8", "reduce_sum_x2", "dep_fetch_l2_row64"):
        assert torch.equal(kp.probe_kernel(name, tab, 50), kp.run_probe_plain(name, tab, 50))
    table = kp.make_dma_table(seed=0, rows=128, rows_per_rec=4, device="cpu")
    assert torch.equal(kp.dma_probe_kernel(table, 8, 4, 10),
                       kp.run_dma_probe_plain(table, 8, 4, 10))
    kp.main(["--iters", "20", "--device", "cpu"])
    assert kp.probe_kernel.launches == 0 and kp.dma_probe_kernel.launches == 0


def test_probe_wrappers_on_a_cuda_tensor_have_no_path_to_the_plain_versions():
    """Each wrapper names its plain version once, under the test that the
    table lies on the CPU; past it the kernel is launched or the call raises,
    with no ``try`` that could swallow a failed build or launch."""
    import inspect

    from unitysimpleraytracing_tpu_torch.benchmarks import kernel_probe as kp

    for wrapper, plain, arg in ((kp.probe_kernel, "run_probe_plain", "tab"),
                                (kp.dma_probe_kernel, "run_dma_probe_plain", "table")):
        src = inspect.getsource(wrapper)
        body = src[src.index('"""', src.index('"""') + 3) + 3:]  # past the docstring
        assert body.count(plain) == 1, wrapper.__name__
        cpu_branch = body.index(f'if {arg}.device.type == "cpu":')
        assert cpu_branch < body.index(plain) < body.index("_load_kernel()")
        assert body.index("err = launch(") < body.index("raise RuntimeError") \
            < body.index(".launches += 1")
        assert f'if {arg}.device.type != "cuda":' in body
        for banned in ("try:", "except", "compile", "torch.jit", "cumsum", "index_select"):
            assert banned not in body, banned
    # The measuring functions go through the wrappers, never around them.
    for fn in (kp.run_probe, kp.run_dma_probe, kp.main):
        assert "_plain" not in inspect.getsource(fn)


def test_probe_kernel_source_is_listed_for_the_build():
    from unitysimpleraytracing_tpu_torch.benchmarks import kernel_probe as kp
    from unitysimpleraytracing_tpu_torch.utils import kernel_build

    assert kp.KERNEL_NAME == "kernel_probe"
    text = open(os.path.join(kernel_build.CSRC_DIR, "kernel_probe.cu"), encoding="utf-8").read()
    assert "__global__" in text and "cudaGetLastError" in text
    for fn in ("kernel_probe_p1_launch", "kernel_probe_p2_launch"):
        assert f'extern "C" int {fn}' in text
    for needs in ("cp.async.cg.shared.global", "cp.async.commit_group", "cp.async.wait_group",
                  "__shfl_xor_sync", "__ldcg", "1103515245u"):
        assert needs in text, needs
    for banned in ("cub::", "thrust::", "#include <torch", "#include <ATen"):
        assert banned not in text
    assert os.path.dirname(kernel_build.library_path("kernel_probe")) == os.path.join(ROOT, "build")
    # Every variant the wrapper can ask for has a case in the kernel's switch.
    for code in sorted({c for c, _, _ in kp.P1_VARIANTS.values()}):
        assert f"= {code}," in text
    smoke = open(os.path.join(ROOT, "chip_smoke.py"), encoding="utf-8").read()
    for phase in ('"probe_vs_plain"', '"probe_path"', '"sah_path"'):
        assert f"emit({phase}" in smoke
    assert '"kernel_probe_p1"' in smoke and '"kernel_probe_p2"' in smoke


def test_build_bvh_default_needs_no_builder_and_launches_nothing_on_cpu():
    scene = pt.build_scene(pt.terrain_mesh(res=12, size=10.0, amplitude=2.0, seed=0), device="cpu")
    bvh = pt.build_bvh(scene)
    again = pt.build_bvh(scene, builder="sah_free")
    assert torch.equal(bvh.sorted_tri, again.sorted_tri) and torch.equal(bvh.left, again.left)
    frame = pt.render_frame(
        scene, bvh, pt.make_camera(eye=(8, 6, 9), target=(0, 0, 0), width=32, height=32,
                                   device="cpu"),
        pt.solid_texture(device="cpu"), np.zeros(3, np.float32), shadows=True)
    assert bool(torch.isfinite(frame).all())
    assert pt4.traverse_bvh4.launches == 0 and pt2.traverse_bvh2.launches == 0


# ---- the redesigned K5 and K1 ------------------------------------------------------


@pytest.mark.parametrize("name, replaces, needs", [
    ("scan", "ops/scan_pallas.py::_kernel",
     ["atomicAdd(control", "st.release.gpu", "ld.acquire.gpu", "__ballot_sync"]),
    ("trace_bvh4", "ops/trace_pallas4.py::_make_kernel4",
     ["__trap()", "__ldg", "k = stack[--sp]"]),
    ("radix_sort", "ops/sort_pallas.py::_hist_kernel",
     ["atomicAdd(accum", "atomicExch(ticket", "__all_sync", "longlong2"]),
    ("radix_sort", "ops/sort_pallas.py::_rank_kernel",
     ["atomicAdd(control", "st.relaxed.gpu", "ld.relaxed.gpu", "__ballot_sync",
      "stage[pos[r]] = key[r]", "__trap()"]),
])
def test_redesigned_kernels_keep_their_replaces_note(name, replaces, needs):
    from unitysimpleraytracing_tpu_torch.utils import kernel_build

    text = open(os.path.join(kernel_build.CSRC_DIR, name + ".cu"), encoding="utf-8").read()
    head = text[:text.index("#include")]
    assert f"Replaces the TPU kernel {replaces}" in " ".join(head.replace("//", "").split())
    assert "What bounds it" in head
    for needed in needs:
        assert needed in text, needed
    # One design, no compile-time switches.
    assert "#if" not in text


def test_scan_on_a_cuda_tensor_has_no_path_to_the_plain_version():
    """`exclusive_scan` names its plain version once, under the test that the
    tensor lies on the CPU; past it the kernel is launched (one launch, no
    plain fallback, no ``try``) or the call raises."""
    import inspect

    src = inspect.getsource(pscan.exclusive_scan)
    body = src[src.index('"""', src.index('"""') + 3) + 3:]  # past the docstring
    assert body.count("exclusive_scan_plain") == 1
    cpu_branch = body.index('if x.device.type == "cpu":')
    assert cpu_branch < body.index("exclusive_scan_plain") < body.index("_load_kernel()")
    assert 'if x.device.type != "cuda":' in body
    launcher = inspect.getsource(pscan._scan_on_card)
    assert launcher.count("fn(") == 1 and "raise RuntimeError" in launcher
    for text in (body, launcher, inspect.getsource(pscan.ScanScratch)):
        for banned in ("try:", "except", "cumsum", "compile"):
            assert banned not in text, banned
    assert "_plain" not in launcher


@pytest.mark.parametrize("wrapper, plain", [
    ("digit_counts", "digit_counts_plain"), ("digit_pass", "digit_pass_plain"),
    ("digit_histogram", "digit_histogram_plain"), ("digit_rank", "digit_rank_plain"),
])
def test_sort_wrappers_on_a_cuda_tensor_have_no_path_to_the_plain_versions(wrapper, plain):
    """Each sort wrapper names its plain version once, under the test that
    the keys lie on the CPU; past it the kernel is launched (one launch, no
    ``try``) or the call raises."""
    import inspect

    src = inspect.getsource(getattr(pcu, wrapper))
    body = src[src.index('"""', src.index('"""') + 3) + 3:]  # past the docstring
    assert body.count(plain) == 1
    cpu_branch = body.index('if keys.device.type == "cpu":')
    assert cpu_branch < body.index(plain) < body.index("_load_kernel()")
    launches = [m.start() for m in re.finditer(r"(?<![\w.])launch\(", body)]
    assert len(launches) == 1 and "raise" in body + inspect.getsource(pcu._check_launch)
    assert launches[0] < body.index(f"{wrapper}.launches += 1")
    for banned in ("try:", "except", "compile", "torch.jit", "bincount", "torch.sort", "cumsum"):
        assert banned not in body, banned


def test_kernel_ab_measures_on_the_card_only(tmp_path):
    from unitysimpleraytracing_tpu_torch.benchmarks import kernel_ab

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            kernel_ab.main([])
    # --root must hold the package; this checkout's is already imported here.
    with pytest.raises(ValueError, match="no unitysimpleraytracing_tpu_torch"):
        kernel_ab.import_package(str(tmp_path))
    (tmp_path / kernel_ab.PKG_NAME).mkdir()
    with pytest.raises(RuntimeError, match="by its path"):
        kernel_ab.import_package(str(tmp_path))
    # The digest that shows two checkouts' kernels agree: order and bits count.
    a, b = torch.arange(4, dtype=torch.int32), torch.tensor([0.5, -0.0])
    assert kernel_ab.digest(a, b) == kernel_ab.digest(a.clone(), b.clone())
    assert kernel_ab.digest(a, b) != kernel_ab.digest(b, a)
    assert kernel_ab.digest(b) != kernel_ab.digest(torch.tensor([0.5, 0.0]))


# ---- the host-side modules and the native bridge ------------------------------------


def test_native_sources_are_listed_for_the_build_and_build_stays_ignored():
    from unitysimpleraytracing_tpu_torch import native

    pkg = os.path.dirname(native.__file__)
    cpp = sorted(n for n in os.listdir(pkg) if n.endswith(".cpp"))
    assert cpp == sorted(native.SOURCES) == ["image.cpp", "ingest.cpp"]
    text = {n: open(os.path.join(pkg, n), encoding="utf-8").read() for n in cpp}
    assert "ObjMesh* obj_load(const char* path)" in text["ingest.cpp"]
    assert "long png_unfilter(" in text["image.cpp"]
    assert "-fPIC" in native.CXX_FLAGS and "-shared" in native.CXX_FLAGS
    assert os.path.dirname(native.library_path()) == os.path.join(ROOT, "build")
    ignored = [ln.strip() for ln in open(os.path.join(ROOT, ".gitignore"), encoding="utf-8")]
    assert "build/" in ignored


def test_no_not_ported_path_is_left_in_the_port():
    pkg = os.path.join(ROOT, "unitysimpleraytracing_tpu_torch")
    for d, _, names in os.walk(pkg):
        for n in names:
            if n.endswith(".py"):
                text = open(os.path.join(d, n), encoding="utf-8").read()
                assert "not ported" not in text and "NotImplementedError" not in text, n


def test_committed_jax_fixtures_stay_under_three_megabytes():
    golden = os.path.join(ROOT, "tests", "golden")
    sizes = {n: os.path.getsize(os.path.join(golden, n))
             for n in os.listdir(golden) if n.startswith("torch_")}
    assert {"torch_config2_hits_jax.npz", "torch_config2_frame_jax.npz",
            "torch_config3_jax.npz", "torch_config4_jax.npz", "torch_1m_jax.npz",
            "torch_config5_chunked_jax.npz", "torch_4m_chunked_jax.npz",
            "torch_config5_dist_jax.npz"} <= set(sizes), sorted(sizes)
    assert sum(sizes.values()) < 3_000_000, sizes


def test_parity_module_imports_neither_jax_nor_torch():
    # utils/parity is the contract that chip_smoke.py and the CPU suite share:
    # numpy only (its package's constants aside).
    path = os.path.join(ROOT, "unitysimpleraytracing_tpu_torch", "utils", "parity.py")
    mods = {line.split()[1].split(".")[0] for line in open(path, encoding="utf-8")
            if line.startswith(("import ", "from "))}
    assert mods <= {"__future__", "hashlib", "types", "numpy",
                    "unitysimpleraytracing_tpu_torch"}, mods
