"""What the benchmark imports: no JAX and no JAX package anywhere, and
nothing of the program in the reference.  Top-level module names are
compared whole: ``subgc_tpu_torch`` is the port, ``subgc_tpu`` the JAX
package."""
from __future__ import annotations

import ast
import glob
import os
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "subgc_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_of_the_benchmark_imports_jax():
    files = glob.glob(os.path.join(ROOT, "portbench", "**", "*.py"),
                      recursive=True)
    assert files
    for path in files:
        assert not set(_imports(path)) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    files = glob.glob(os.path.join(ROOT, "portbench", "reference", "*.py"))
    for path in files:
        assert set(_imports(path)) <= {"__future__", "math", "numpy",
                                       "torch"}, path


def test_a_run_loads_no_jax():
    code = (
        "import sys\n"
        "sys.path.insert(0, 'portbench/tests')\n"
        "from conftest import small_run\n"
        "from portbench import harness as H\n"
        "for name in ('sub_gc.kar_test', 'full_gc.kar_train'):\n"
        "    H.execute(small_run(name, seconds=0.1))\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
    assert "subgc_tpu_torch" in loaded and "torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_harness_finds_the_jax_package_by_its_whole_name():
    code = ("import sys, types\n"
            "sys.modules['subgc_tpu'] = types.ModuleType('subgc_tpu')\n"
            "from portbench import harness as H\n"
            "print(H.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=60)
    assert out.stdout.strip() == "['subgc_tpu']"
