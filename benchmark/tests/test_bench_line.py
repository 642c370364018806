"""The result line of a run (here on the CPU at a tiny size: the harness's
look for a card is skipped): its keys, in order, with each compared number
beside its limit last."""

import json
import sys

import pytest

from benchmark.harness import cell, spec

from . import tiny

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", ["cz.gradgen", "ensemble32.full"])
def test_untraced_line(name):
    line, lines = tiny.run(name)
    assert list(line) == RESULT_KEYS + ["checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    sp = spec.cell_spec(name)
    assert set(line["metrics"]) == {m["name"] for m in sp["end_to_end"]}
    for m in sp["end_to_end"]:
        assert line["metrics"][m["name"]]["unit"] == m["unit"]
        assert line["metrics"][m["name"]]["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    limits = sp["check"]["limits"]
    assert list(line["checks"]) == list(limits)
    assert all(set(v) == {"value", "limit"} for v in line["checks"].values())
    # each compared number beside its limit, as the last lines
    tail = lines[-len(limits):]
    assert [t.split()[0] for t in tail] == list(limits)
    assert all(" limit " in t for t in tail)
    assert lines[0].startswith("setup_parts ")
    json.dumps(line)
    assert not {m.split(".")[0] for m in sys.modules} & set(cell.FORBIDDEN)


@pytest.mark.parametrize("name", ["cz.taylor", "ensemble32.full"])
def test_traced_line(name):
    line, _ = tiny.run(name, trace=True)
    assert list(line) == RESULT_KEYS + ["breakdown", "checks"]
    per_layer = {m["name"] for m in spec.cell_spec(name)["per_layer"]}
    # the CPU has no device trace: the host readers read, the device ones
    # read nothing; each under the cell's own name of its quantity
    host = {m for m in per_layer if cell.base_name(m) in (
        "loop_host_ms", "eval_ms", "evals_per_iter", "eval_mfu")}
    assert len(host) == 4
    assert host <= set(line["metrics"]) <= per_layer
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
