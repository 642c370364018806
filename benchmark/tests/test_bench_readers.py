"""Every per-layer reader on synthetic spans, counters and a small Chrome
trace, and the trace's breakdown."""

import importlib.util
import json
import os
from types import SimpleNamespace as Context

import numpy as np
import pytest

from benchmark.counts import frechet, peaks, propagators, state_scan
from benchmark.harness import spec
from benchmark.harness.breakdown import breakdown
from benchmark.harness.readings import kernel_base
from benchmark.harness.window import Window

BENCH = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))


def reader(name):
    path = os.path.join(spec.BENCH_DIR, "metrics", name + ".py")
    module_spec = importlib.util.spec_from_file_location("r_" + name, path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module.read


class FakeRecorder:
    def __init__(self, spans=(), kernel_calls=(), events=None, slice_=None):
        self.spans = list(spans)
        self.kernel_calls = list(kernel_calls)
        self.events = events
        self.slice = slice_


STRUCT = {"d": 100, "G": 1, "gs": 4, "K": 4, "T": 4, "L": 4, "N_T": 2000,
          "dt": 0.025, "h0_norm": 60.0, "op_norms": [3.0, 3.0, 3.0, 3.0]}
PROP = {"d": 100, "G": 1, "T": 4, "N_T": 2000, "coeff_values": 8000, "s": 0}
SCAN = {"C": 2000, "G": 1, "K": 4, "d": 100, "chi": False, "carry": False}
FRE = {"G": 1, "T": 4, "d": 100, "N_T": 2000, "K": 4, "coeff_values": 8000,
       "s": 0}


def window(iters):
    """A closed window of iterations of ``iters`` seconds, from t = 0."""
    w = Window(sum(iters), np.random.default_rng(0), 1)
    t = 0.0
    w.t_start = 0.0
    for s in iters:
        t += s
        w.iter_s.append(s)
        w.iter_end.append(t)
    w.t_end = t
    w.solves = [{"iterations": len(iters), "fg_calls": len(iters) + 2,
                 "f_calls": 0, "J_T": 0.1, "message": "x"}]
    return w


def trace_events():
    """Two evaluations' kernels with gaps, on a 10 ms slice."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.evaluation",
           "ts": 0.0, "dur": 5000.0},
          {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 4500.0,
           "dur": 400.0},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 9000.0,
           "dur": 1000.0}]
    for t0, name, dur in ((100.0, "void grape::propagator_cluster_kernel"
                           "<4>(float2 const*, int)", 2000.0),
                          (2100.0, "state_scan_kernel<0, 4>(float2*)", 1000.0),
                          (3200.0, "frechet_factored_kernel(float*)", 1200.0),
                          (6000.0, "Memcpy DtoH (Device -> Pinned)", 100.0)):
        cat = "gpu_memcpy" if name.startswith("Memcpy") else "kernel"
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": t0,
                   "dur": dur})
    return ev


def test_kernel_base_names():
    assert kernel_base("void grape::propagator_cluster_kernel<4>(float2 "
                       "const*, int)") == "propagator_cluster_kernel"
    assert kernel_base("state_scan_kernel<0, 4>(float2*)") == (
        "state_scan_kernel")
    assert kernel_base("frechet_factored_kernel") == "frechet_factored_kernel"
    assert kernel_base("void at::native::(anonymous namespace)::reduce_kernel"
                       "<128, 4>(int)") == "reduce_kernel"


def test_host_readers_on_synthetic_spans():
    w = window([0.030, 0.040, 0.050, 0.020])
    amps = np.array([0.05, 0.01, 0.05, 0.01])
    spans = [(0.002, 0.027, "evaluate_gradient", amps),
             (0.033, 0.053, "evaluate_gradient", amps),
             (0.054, 0.068, "evaluate_gradient", amps),
             (0.073, 0.113, "evaluate_gradient", amps),
             (0.121, 0.139, "evaluate_gradient", amps)]
    # the third iteration lies in the profiled slice and is left out
    rec = FakeRecorder(spans=spans, slice_=(0.075, 0.120))
    ctx = Context(window=w, recorder=rec, structure=STRUCT,
                  traffic={"options": {"gradient_method": "gradgen"}},
                  window_peak_bytes=3 * 2**30)
    kept_iter = 0.030 + 0.040 + 0.020
    kept_span = 0.025 + 0.020 + 0.014 + 0.018
    assert reader("loop_host_ms")(ctx) == pytest.approx(
        (kept_iter - kept_span) / 3 * 1e3)
    assert reader("eval_ms")(ctx) == pytest.approx(kept_span / 4 * 1e3)
    assert reader("evals_per_iter")(ctx) == pytest.approx(6 / 4)
    assert reader("peak_mem_gib")(ctx) == pytest.approx(3.0)
    mfu = reader("eval_mfu")(ctx)
    assert 0.0 < mfu < 100.0
    ctx.traffic = {"options": {"gradient_method": "taylor"}}
    assert 0.0 < reader("eval_mfu")(ctx) < 100.0


def test_host_readers_read_nothing_without_spans():
    ctx = Context(window=window([0.03]), recorder=None, structure=STRUCT,
                  traffic={"options": {}}, window_peak_bytes=None)
    for name in ("loop_host_ms", "eval_ms", "eval_mfu", "kernel_roofline",
                 "device_idle", "peak_mem_gib"):
        assert reader(name)(ctx) is None


def test_trace_readers_on_a_small_chrome_trace():
    calls = [("propagators", PROP), ("state_scan", SCAN),
             ("frechet", FRE)]
    rec = FakeRecorder(kernel_calls=calls, events=trace_events())
    ctx = Context(window=window([0.01]), recorder=rec, structure=STRUCT,
                  traffic={"options": {}}, window_peak_bytes=None)
    bound = sum(peaks.bound(*m.of_call(s))[0] for m, s in (
        (propagators, PROP), (state_scan, SCAN), (frechet, FRE)))
    assert reader("kernel_roofline")(ctx) == pytest.approx(
        bound / 4.2 * 100)
    busy = 2000 + 1000 + 1200 + 100
    assert reader("device_idle")(ctx) == pytest.approx(
        (1 - busy / 10000) * 100)
    # a wrapper whose kernels ran but whose calls were not seen: nothing
    rec.kernel_calls = calls[:2]
    assert reader("kernel_roofline")(ctx) is None
    rec.kernel_calls = calls[:2] + [("frechet", None)]
    assert reader("kernel_roofline")(ctx) is None


def test_breakdown_names_ops_and_gaps():
    out, busy_s, window_s = breakdown(trace_events())
    assert out["device_ops"][0] == ["propagator_cluster_kernel", 0.002]
    assert len(out["device_ops"]) == 4
    gaps = dict((round(g, 6), n) for n, g in out["idle_gaps"])
    assert gaps[0.0016] == "host between evaluations"  # 4400..6000 us
    assert gaps[0.0001] == "bench.evaluation"       # 2000..2100
    assert busy_s == pytest.approx(0.0043)
    assert window_s == pytest.approx(0.010)
    assert all(len(v) <= 10 for v in out.values())


def test_per_layer_metrics_name_their_layer_and_cells():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m["workloads"]) <= cells
        assert m["layer"] in ("outer loop", "evaluation", "kernels",
                              "collectives", "device")
