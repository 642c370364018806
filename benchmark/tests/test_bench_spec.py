"""The benchmark finds its configurations, cells and metric readers by
name, and ``BENCHMARK.json`` keeps to the form the harness and its check
read."""

import importlib.util
import json
import os
import re

import pytest

from benchmark.harness import cell as cell_run
from benchmark.harness import check, spec

ROOT = spec.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_entries_have_just_their_keys_and_valid_names():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    sp = spec.cell_spec(cell)
    assert sp["config"]["name"] == sp["cell"]["config"]
    assert {"options", "guess", "solve_iter_stop",
            "warmup_iter_stop"} <= set(sp["traffic"])
    limits = sp["check"]["limits"]
    assert {"J_T_gap", "grad_gap", "J_T_rise"} <= set(limits)
    assert set(limits) <= set(check.NUMBERS)
    assert limits["J_T_rise"] == 0.0
    # the outer loop's path is followed where it has iterations to follow
    assert (sp["check"].get("path_iterations", 0) > 0) == (
        "path_J_gap" in limits)
    # set-up and the rate, under the name of the cell's group
    bases = {cell_run.base_name(m["name"]) for m in sp["end_to_end"]}
    assert {"setup_s", "iters_per_s"} <= bases
    assert sp["per_layer"]


@pytest.mark.parametrize("entry", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_configuration_files(entry):
    path = os.path.join(ROOT, entry["file"])
    assert entry["file"].startswith("benchmark/configs/")
    cfg = json.load(open(path))
    assert cfg["name"] == entry["name"]
    assert cfg["reduced"] == entry["reduced"]
    assert cfg["source"] == entry["source"]
    from benchmark import programs, reference

    assert hasattr(reference.load(cfg["kind"]), "Reference")
    assert hasattr(programs.load(cfg["kind"]), "Program")


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=[m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    base = cell_run.base_name(metric["name"])
    path = os.path.join(spec.BENCH_DIR, "metrics", base + ".py")
    module_spec = importlib.util.spec_from_file_location("reader", path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    assert callable(module.read)


def test_files_under_paths_are_named_from_name_characters():
    bad = []
    for base, dirs, names in os.walk(spec.BENCH_DIR):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for n in names + dirs:
            if not re.match(r"^[A-Za-z0-9_.-]+$", n):
                bad.append(os.path.join(base, n))
    assert not bad
