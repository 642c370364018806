"""The readers of the port's ``grape.*`` spans (``lbfgsb_ms``,
``dispatch_ms``, ``launches_per_eval``, ``idle_eval``, ``idle_loop``) on a
synthetic Chrome trace with exact answers, on a trace without the spans (a
program that has none) and without device events (the CPU), and in one
traced run of the tiny CZ cell on the CPU."""

import importlib.util
import json
import os
from types import SimpleNamespace as Context

import numpy as np
import pytest

from benchmark.harness import spec
from benchmark.harness.readings import slice_span
from benchmark.harness.window import Window
from benchmark.metrics.idle_eval import overlap, subtract

from . import tiny

SPAN_READERS = ("lbfgsb_ms", "dispatch_ms", "launches_per_eval", "idle_eval",
                "idle_loop")
BENCH = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))


def reader(name):
    path = os.path.join(spec.BENCH_DIR, "metrics", name + ".py")
    module_spec = importlib.util.spec_from_file_location("s_" + name, path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module.read


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def span_trace(device=True):
    """A 10 ms slice (µs): two evaluations between the loop's own spans,
    and spans still open at the profiler's stop (clipped at 10000).

    - loop: ``grape.lbfgsb`` 0-500 and 5500-6000, ``grape.update_result``
      4500-4800, ``grape.callback`` 4800-5500;
    - evaluations 500-4500 (dispatch 600-2600) and 6000-9000 (dispatch
      6100-7100);
    - the card: busy 700-2000, 2100-4000, 4300-4400 (copy), 5000-5200
      (inside the callback), 6200-8500;
    - launches at 650, 2050 and 6150 (inside evaluations) and 4950 (in the
      callback), and a copy call at 4250 that is no launch;
    - the card's ``gpu_user_annotation`` copies of two ranges, which the
      readers leave out;
    - clipped at the stop, each left out: ``grape.solve`` 0-10000,
      ``grape.callback`` 9200-10000, and in it a ``grape.lbfgsb``, a
      ``grape.evaluate_gradient`` with a ``grape.dispatch`` and a launch
      at 9600."""
    ua = "user_annotation"
    ev = [_x(ua, "grape.solve", 0.0, 10000.0),
          _x(ua, "grape.lbfgsb", 0.0, 500.0),
          _x(ua, "grape.evaluate_gradient", 500.0, 4000.0),
          _x(ua, "grape.dispatch", 600.0, 2000.0),
          _x(ua, "grape.readback", 2600.0, 1900.0),
          _x(ua, "grape.update_result", 4500.0, 300.0),
          _x(ua, "grape.callback", 4800.0, 700.0),
          _x(ua, "grape.lbfgsb", 5500.0, 500.0),
          _x(ua, "grape.evaluate_gradient", 6000.0, 3000.0),
          _x(ua, "grape.dispatch", 6100.0, 1000.0),
          _x(ua, "grape.callback", 9200.0, 800.0),
          _x(ua, "grape.lbfgsb", 9300.0, 700.0),
          _x(ua, "grape.evaluate_gradient", 9500.0, 500.0),
          _x(ua, "grape.dispatch", 9550.0, 450.0),
          # the card's drawing of two ranges' kernels: not the host's time
          _x("gpu_user_annotation", "grape.dispatch", 700.0, 3300.0),
          _x("gpu_user_annotation", "grape.evaluate_gradient", 700.0,
             8000.0),
          _x("cuda_runtime", "cudaLaunchKernel", 650.0, 10.0),
          _x("cuda_runtime", "cudaLaunchKernelExC", 2050.0, 10.0),
          _x("cuda_runtime", "cudaMemcpyAsync", 4250.0, 10.0),
          _x("cuda_runtime", "cudaLaunchKernel", 4950.0, 10.0),
          _x("cuda_driver", "cuLaunchKernelEx", 6150.0, 10.0),
          _x("cuda_runtime", "cudaLaunchKernel", 9600.0, 10.0)]
    if device:
        ev += [_x("kernel", "propagator_cluster_kernel", 700.0, 1300.0),
               _x("kernel", "frechet_factored_kernel", 2100.0, 1900.0),
               _x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 4300.0,
                  100.0),
               _x("kernel", "reduce_kernel", 5000.0, 200.0),
               _x("kernel", "state_scan_kernel", 6200.0, 2300.0)]
    return ev


def context(events, iter_end=(3000.0, 7000.0, 12000.0),
            slice_us=(100.0, 10000.0)):
    """The readers' namespace: a window whose iterations end at
    ``iter_end`` (µs), and a recorder whose slice spans ``slice_us``."""
    w = Window(1.0, np.random.default_rng(0), 1)
    w.iter_end = [t / 1e6 for t in iter_end]
    w.iter_s = [0.005] * len(iter_end)
    rec = Context(events=events, spans=[], kernel_calls=[],
                  slice=tuple(t / 1e6 for t in slice_us))
    return Context(window=w, recorder=rec, traffic={"options": {}},
                   structure={}, window_peak_bytes=None)


def test_span_readers_on_a_synthetic_trace():
    ctx = context(span_trace())
    # two lbfgsb spans of 500 µs over the two iterations ending in the
    # slice (at 3 and 7 ms)
    assert reader("lbfgsb_ms")(ctx) == pytest.approx(0.5)
    assert reader("dispatch_ms")(ctx) == pytest.approx(1.5)
    assert reader("launches_per_eval")(ctx) == pytest.approx(1.5)
    # idle inside the evaluations: 700 + 700 µs of 10000
    assert reader("idle_eval")(ctx) == pytest.approx(14.0)
    # idle in the loop: 500 (first lbfgsb) + 1500 - 200 (4500-6000)
    assert reader("idle_loop")(ctx) == pytest.approx(18.0)
    # the rest of device_idle lies under no span of the loop: 9000-10000
    assert reader("device_idle")(ctx) == pytest.approx(42.0)


def test_spans_open_at_the_stop_are_left_out():
    ev = span_trace()
    t1 = slice_span(ev)[1]
    assert t1 == 10000.0
    ctx = context(ev)
    # the clipped ones moved to before the end change every reading
    moved = [dict(e, dur=e["dur"] - 1.0)
             if e["ts"] + e["dur"] == t1 and e["cat"] == "user_annotation"
             else e for e in ev]
    moved.append(_x("Trace", "PyTorch Profiler (0)", 0.0, 10000.0))
    ctx_moved = context(moved)
    for name in SPAN_READERS:
        assert reader(name)(ctx) != pytest.approx(reader(name)(ctx_moved)), (
            name)


def test_span_readers_without_device_events():
    ctx = context([e for e in span_trace(device=False)
                   if e["cat"] in ("user_annotation", "gpu_user_annotation")])
    assert reader("lbfgsb_ms")(ctx) == pytest.approx(0.5)
    assert reader("dispatch_ms")(ctx) == pytest.approx(1.5)
    for name in ("launches_per_eval", "idle_eval", "idle_loop"):
        assert reader(name)(ctx) is None, name
    # launches without kernels still count
    ctx = context(span_trace(device=False))
    assert reader("launches_per_eval")(ctx) == pytest.approx(1.5)
    assert reader("idle_eval")(ctx) is None


def test_span_readers_read_nothing_without_spans():
    # a program without the port's spans (the harness's own label only)
    ev = [dict(e, name="bench.evaluation") if e["name"].startswith("grape.")
          else e for e in span_trace()]
    ctx = context(ev)
    for name in SPAN_READERS:
        assert reader(name)(ctx) is None, name
    ctx = context([])
    ctx.recorder.events = []
    for name in SPAN_READERS:
        assert reader(name)(ctx) is None, name
    ctx.recorder = None
    for name in SPAN_READERS:
        assert reader(name)(ctx) is None, name


def test_lbfgsb_ms_needs_iterations_in_the_slice():
    assert reader("lbfgsb_ms")(context(span_trace(),
                                       iter_end=(20000.0,))) is None


@pytest.mark.parametrize("xs, ys, left, common", [
    ([[0, 10]], [[2, 3], [5, 7]], [[0, 2], [3, 5], [7, 10]], 3),
    ([[0, 4], [6, 9]], [[3, 7]], [[0, 3], [7, 9]], 2),
    ([[0, 4]], [[0, 4]], [], 4),
    ([[0, 4]], [], [[0, 4]], 0),
    ([[1, 2], [3, 4]], [[0, 10]], [], 2),
])
def test_interval_arithmetic(xs, ys, left, common):
    assert subtract(xs, ys) == left
    assert overlap(xs, ys) == common
    assert overlap(ys, xs) == common


def test_the_new_entries_are_read_in_their_cells():
    per_layer = {m["name"]: m for m in BENCH["per_layer"]}
    for base in SPAN_READERS:
        assert per_layer[base]["workloads"] == ["cz.gradgen", "cz.taylor"]
        assert per_layer[base]["moves"] == "iters_per_s"
        ens = per_layer[base + ".ensemble"]
        assert ens["workloads"] == ["ensemble32.recompute", "ensemble32.full"]
        assert ens["moves"] == "iters_per_s.ensemble"
        assert per_layer[base]["source"] == ens["source"] == "device_trace"


def test_a_traced_cpu_run_reads_the_host_spans():
    line, _ = tiny.run("cz.gradgen", trace=True)
    assert line["correct"] is True
    metrics = line["metrics"]
    assert metrics["lbfgsb_ms"]["value"] > 0
    assert metrics["dispatch_ms"]["value"] > 0
    # no card: nothing launched, no device interval
    for name in ("launches_per_eval", "idle_eval", "idle_loop"):
        assert name not in metrics
    names = {n for n, _ in line["breakdown"]["idle_gaps"]}
    assert not names or all(n.startswith(("grape.", "bench.")) for n in names)

