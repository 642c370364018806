"""The import guard: what the benchmark runs loads nothing of JAX or of the
JAX package (top-level module names compared whole, so ``grape_tpu_torch``
passes), and the reference loads nothing of the program."""

import ast
import os
import subprocess
import sys

from benchmark.harness import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "grape_tpu")
PROBE = r"""
import sys, runpy
sys.path.insert(0, {root!r})
runpy.run_path({run!r}, run_name="dry")     # run.py without its main
import benchmark.reference, benchmark.reference.two_transmon_gate
import benchmark.harness.cell, benchmark.control
from benchmark.tests import tiny
tiny.run("ensemble32.recompute", trace=True)  # drives the program too
top = sorted({{m.split(".")[0] for m in sys.modules}})
print(",".join(top))
"""


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _files(sub=""):
    out = []
    for base, dirs, names in os.walk(os.path.join(spec.BENCH_DIR, sub)):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        out += [os.path.join(base, n) for n in names if n.endswith(".py")]
    return out


def test_a_run_loads_nothing_of_jax():
    src = PROBE.format(root=spec.ROOT,
                       run=os.path.join(spec.BENCH_DIR, "run.py"))
    out = subprocess.run([sys.executable, "-c", src], capture_output=True,
                         text=True, timeout=600, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(out.stdout.strip().splitlines()[-1].split(","))
    assert "grape_tpu_torch" in top and "torch" in top
    assert not top & set(FORBIDDEN)


def test_no_benchmark_file_imports_jax():
    files = _files()
    assert len(files) > 20
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_the_reference_imports_nothing_of_the_program():
    files = _files("reference")
    assert any(f.endswith("two_transmon_gate.py") for f in files)
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN + ("grape_tpu_torch",
                                                         "benchmark"), (
                path, name)
