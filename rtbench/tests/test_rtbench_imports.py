"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program: by the top-level module name
(the part before the first dot), compared whole."""
from __future__ import annotations

import ast
import glob
import os
import subprocess
import sys

from conftest import ROOT

from rtbench.run import FORBIDDEN, forbidden_modules

PROGRAM = "unitysimpleraytracing_tpu_torch"
# The reference and what it imports of the benchmark.
REFERENCE = ("reference.py", "judge.py", "seeds.py", "scenes/terrain.py", "textures/texels.py")


def top_level_imports(path: str) -> set[str]:
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def harness_files():
    here = os.path.join(ROOT, "rtbench")
    return [p for p in glob.glob(os.path.join(here, "**", "*.py"), recursive=True)
            if os.sep + "tests" + os.sep not in p]


def test_no_harness_file_imports_jax_or_the_jax_package():
    for path in harness_files():
        assert not top_level_imports(path) & set(FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for name in REFERENCE:
        names = top_level_imports(os.path.join(ROOT, "rtbench", name))
        assert PROGRAM not in names and not names & set(FORBIDDEN), name
        assert names <= {"__future__", "math", "random", "numpy", "torch", "rtbench"}, name


def test_names_are_compared_whole():
    assert forbidden_modules(["jax.numpy", "unitysimpleraytracing_tpu.core", "os"]) == [
        "jax.numpy", "unitysimpleraytracing_tpu.core"]
    assert forbidden_modules([PROGRAM, PROGRAM + ".ops", "jaxtyping", "flaxen"]) == []


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from conftest import tiny_config\n"
        "from rtbench.manifest import Manifest\nfrom rtbench import run\n"
        "m = Manifest(%r)\n"
        "r = run.run_cell(m, 'terrain65k.deform_refit', 5, 0.2, False, device='cpu',\n"
        "                 config=tiny_config(m.cell('terrain65k.deform_refit')))\n"
        "assert r['correct'], r\n"
        "print(sorted({k.split('.')[0] for k in sys.modules}))\n"
        "sys.exit(3 if run.forbidden_modules() else 0)\n"
    ) % (os.path.dirname(__file__), ROOT)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    assert PROGRAM in p.stdout


def test_without_a_card_the_run_prints_nothing_and_fails():
    p = subprocess.run(
        [sys.executable, "rtbench/run.py", "--workload", "terrain65k.deform_refit",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and p.stdout == ""
