"""The command refuses to measure where it cannot: without a card, and in
a directory that holds only ``BENCHMARK.json`` and the benchmark's files
(the program is missing there).  Either way it exits with another code
than 0 and prints no result."""

import json
import os
import shutil
import subprocess
import sys

from benchmark.harness import spec

ARGS = ["--workload", "cz.gradgen", "--seed", "0", "--seconds", "10",
        "--trace", "0"]


def _prints_a_result(stdout):
    for text in stdout.strip().splitlines()[-1:]:
        try:
            return isinstance(json.loads(text), dict)
        except ValueError:
            return False
    return False


def test_without_a_card_it_exits_and_says_why(no_card):
    out = subprocess.run(
        [sys.executable, os.path.join("benchmark", "run.py"), *ARGS],
        capture_output=True, text=True, timeout=300, cwd=spec.ROOT)
    assert out.returncode != 0
    assert "no CUDA card" in out.stderr
    assert not _prints_a_result(out.stdout)


def test_in_a_directory_of_the_benchmark_alone_it_exits(tmp_path):
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, os.path.join("benchmark", "run.py"), *ARGS],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0
    assert not _prints_a_result(out.stdout)
