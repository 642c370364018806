"""The Chebyshev cell ``cz1024.cheby``: the scan's frozen counts against the
kernel table's reckoning (``chip_smoke.cheby_flops_bytes``) and its term
count against the program's tables; the readers ``cheby_roofline``,
``taylor_pass_ms``, ``taylor_roofline`` and ``eval_mfu_cheby`` on a
synthetic Chrome trace with exact answers, and on traces without the
port's spans or the scan's kernels; the kind ``two_transmon_gate_large``
and its structure; and the cell run on the CPU at the tiny size, untraced
and traced."""

import importlib.util
import json
import os
from types import SimpleNamespace as Context

import numpy as np
import pytest

from benchmark.counts import cheby, envelope, peaks, taylor
from benchmark.harness import spec
from benchmark.harness.window import Window

from . import tiny

CELL = "cz1024.cheby"
BENCH = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))
NEW = ("cheby_roofline", "taylor_pass_ms", "taylor_roofline",
       "eval_mfu_cheby")
# the cell's counted structure at dim 1024 (``Program.structure()``)
STRUCT = {"d": 1024, "G": 1, "gs": 4, "K": 4, "T": 4, "L": 4, "N_T": 100,
          "dt": 0.01, "h0_norm": 1007.5, "op_norms": [5.5225] * 4,
          "h0_range": [-1007.5, 0.5127], "op_radii": [5.0387] * 4}
AMPS = np.array([2.5, 0.5, 2.5, 0.5])


def reader(name):
    path = os.path.join(spec.BENCH_DIR, "metrics", name + ".py")
    module_spec = importlib.util.spec_from_file_location("c_" + name, path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module.read


def test_counts_match_the_kernel_tables_reckoning():
    import chip_smoke

    shape = (1024, 4, 4, 100, 27)
    fl, by = chip_smoke.cheby_flops_bytes(*shape)
    assert cheby.flops(*shape) == fl
    assert cheby.nbytes(*shape) == by
    # the K8 row of PERF.md: 89.5 GFLOP, 45.3 MB, 1.335 ms by operations
    assert fl / 1e9 == pytest.approx(89.5, abs=0.05)
    assert peaks.bound(fl, by) == (pytest.approx(1.335, abs=5e-4),
                                   "operations")


def test_terms_are_the_bessel_tail():
    from scipy.special import jv

    for a in (0.3, 2.0, 5.34, 6.5, 11.0):
        n = cheby.terms(a)
        assert abs(jv(n - 1, a)) >= cheby.TOLERANCE
        assert all(abs(jv(k, a)) < cheby.TOLERANCE
                   for k in range(n, n + 40))
    assert cheby.terms(1e-9) == 2
    assert cheby.alpha(0.01, [-10.0, 2.0], [3.0, 1.0], [2.0, -1.0]) == (
        pytest.approx(0.5 * 0.01 * (12.0 + 2 * (6.0 + 1.0))))


@pytest.fixture(scope="module")
def cell_program():
    """The cell's program and compiled problem at its own size (dim 1024;
    the operators and their spectra only, no evaluation)."""
    from benchmark.harness import inputs
    from benchmark.programs import two_transmon_gate_large as kind
    from grape_tpu_torch import fg as F
    from grape_tpu_torch.workspace import _compile_kwargs

    sp = spec.cell_spec(CELL)
    config, traffic = sp["config"], sp["traffic"]
    program = kind.Program(config, inputs.draw(config, 7))
    problem = program.problem(inputs.guess(config, traffic, 7, 0))
    kwargs = dict(problem.kwargs, **traffic["options"],
                  dtype=np.complex64, device="cpu")
    cp = F.compile_problem(problem.trajectories, problem.tlist,
                           **_compile_kwargs(kwargs))
    return program, cp


@pytest.mark.parametrize("amps", [
    [2.5, 0.5, 2.5, 0.5], [8.0, 1.0, 8.0, 1.0], [0.05, 0.05, 0.05, 0.05],
    [16.0, 4.0, 16.0, 4.0], [3.1, 0.2, 1.7, 0.9],
])
def test_the_count_never_exceeds_the_programs_series(cell_program, amps):
    """At the same amplitudes the program's table (its spectral envelope
    widened by 5% a side, three terms past the last above its tolerance)
    is at least as wide as the count."""
    from grape_tpu_torch import fg as F

    program, cp = cell_program
    st = program.structure()
    pd = F._cheby_data(cp, np.array(amps))
    n = cheby.terms(cheby.alpha(st["dt"], st["h0_range"], st["op_radii"],
                                amps))
    assert n <= pd["tab_fw"].shape[1]
    assert n <= pd["tab_bw"].shape[1]
    # the same spectrum: the program's width less its margin
    assert pd["dE"] / 1.1 == pytest.approx(
        2.0 * cheby.alpha(st["dt"], st["h0_range"], st["op_radii"], amps)
        / st["dt"], rel=1e-7)  # the program's operators in complex64


def test_the_kinds_structure(cell_program):
    program, _ = cell_program
    st = program.structure()
    assert set(st) == set(STRUCT)
    for key in ("d", "G", "gs", "K", "T", "L", "N_T"):
        assert st[key] == STRUCT[key], key
    assert st["h0_range"] == pytest.approx(STRUCT["h0_range"], abs=1e-3)
    assert st["op_radii"] == pytest.approx(STRUCT["op_radii"], abs=1e-3)


# -- the readers --------------------------------------------------------------


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def cheby_trace(spans=True):
    """A 100 ms slice (µs): two gradient evaluations (1000-41000,
    50000-90000) and one functional-only evaluation (42000-48000), and a
    span still open at the stop.

    - each gradient evaluation: a forward ring kernel (9000 µs), the
      co-state chain (an adjoint ring kernel of 9000 µs), then the Taylor
      pass, whose host span launches two kernels (20000 and 5000 µs) and a
      copy (500 µs), all three running past the span's end; after the
      pass a glue kernel (300 µs) launched outside it;
    - the functional-only evaluation: one grid-barrier kernel (2000 µs);
    - clipped at the stop: an evaluation with a Taylor pass at 95000."""
    ua, rt = "user_annotation", "cuda_runtime"
    ev = []
    corr = [100]

    def launch(t_host, t_dev, dur, name="ampere_cgemm", cat="kernel",
               call="cudaLaunchKernel"):
        corr[0] += 1
        ev.append(_x(rt, call, t_host, 5.0, corr[0]))
        ev.append(_x(cat, name, t_dev, dur, corr[0]))

    for t0 in (1000.0, 50000.0):
        ev.append(_x(ua, "grape.evaluate_gradient", t0, 40000.0))
        launch(t0 + 10, t0 + 100, 9000.0, "void grape::cheby_ring_kernel"
               "<8, 4>(grape::Args)", call="cudaLaunchKernelExC")
        ev.append(_x(ua, "grape.costates", t0 + 200, 100.0))
        launch(t0 + 210, t0 + 9200, 9000.0, "cheby_ring_kernel<8, 4>")
        ev.append(_x(ua, "grape.taylor_pass", t0 + 400, 3000.0))
        launch(t0 + 500, t0 + 18300, 20000.0)
        launch(t0 + 600, t0 + 38400, 5000.0, "reduce_kernel")
        launch(t0 + 700, t0 + 43500, 500.0, "Memcpy DtoD", "gpu_memcpy",
               "cudaMemcpyAsync")
        launch(t0 + 4000, t0 + 44100, 300.0, "elementwise_kernel")
    ev.append(_x(ua, "grape.evaluate_functional", 42000.0, 6000.0))
    launch(42010.0, 45000.0, 2000.0, "grape::cheby_scan_kernel(float2*)")
    # open at the stop: left out by the span readers
    ev.append(_x(ua, "grape.evaluate_gradient", 95000.0, 5000.0))
    ev.append(_x(ua, "grape.taylor_pass", 96000.0, 4000.0))
    launch(96100.0, 96200.0, 3800.0)
    if not spans:
        ev = [e for e in ev if not e["name"].startswith("grape.")]
    return ev


def context(events, spans=None, struct=STRUCT, window_spans=None):
    """The readers' namespace: the slice (0.1-0.2 s of the host's clock),
    the benchmark's evaluation spans inside it (``spans``) and outside it
    (``window_spans``, in the iterations ending at 0.05 and 0.3 s)."""
    w = Window(1.0, np.random.default_rng(0), 1)
    w.iter_end = [0.05, 0.2, 0.3]
    w.iter_s = [0.05, 0.15, 0.1]
    inside = spans if spans is not None else [
        (0.101, 0.141, "evaluate_gradient", AMPS),
        (0.142, 0.148, "evaluate_functional", AMPS),
        (0.150, 0.190, "evaluate_gradient", AMPS)]
    rec = Context(events=events, spans=list(window_spans or []) + inside,
                  kernel_calls=[], slice=(0.1, 0.2))
    return Context(window=w, recorder=rec,
                   traffic={"options": {"prop_method": "cheby",
                                        "gradient_method": "taylor"}},
                   structure=struct, window_peak_bytes=None)


def test_cheby_roofline_on_a_synthetic_trace():
    ctx = context(cheby_trace())
    one = peaks.bound(*cheby.direction(STRUCT, AMPS))[0]
    # 2 + 1 + 2 directions against 9 + 9 + 2 + 9 + 9 ms of the scan's
    # kernels; the pass's kernels are not the scan's
    assert reader("cheby_roofline")(ctx) == pytest.approx(
        5 * one / 38.0 * 100.0)
    assert 0.0 < reader("cheby_roofline")(ctx) < 100.0


def test_taylor_pass_ms_follows_the_launches():
    # per gradient evaluation: 20000 + 5000 + 500 µs launched in the pass,
    # whatever the card's time of running; the glue after it not; the
    # clipped pass left out with its evaluation
    assert reader("taylor_pass_ms")(context(cheby_trace())) == (
        pytest.approx(25.5))


def test_taylor_roofline_on_a_synthetic_trace():
    ctx = context(cheby_trace())
    st = STRUCT
    m = envelope.taylor_orders(
        envelope.step_norm(st["dt"], st["h0_norm"], st["op_norms"], AMPS),
        max(st["op_norms"]) / (st["h0_norm"] + AMPS @ st["op_norms"]))
    assert m == 44
    flops = 2 * taylor.pass_flops(1024, 4, 4, 100, m)
    assert reader("taylor_roofline")(ctx) == pytest.approx(
        flops / peaks.PEAK_FP32_FLOPS / 0.051 * 100.0)
    assert 0.0 < reader("taylor_roofline")(ctx) < 100.0


def test_eval_mfu_cheby_counts_the_chains_and_the_pass():
    outside = [(0.01, 0.04, "evaluate_gradient", AMPS),
               (0.20, 0.24, "evaluate_gradient", AMPS),
               (0.25, 0.26, "evaluate_functional", AMPS)]
    ctx = context(cheby_trace(), window_spans=outside)
    d_fl = cheby.direction(STRUCT, AMPS)[0]
    p_fl = taylor.pass_flops(1024, 4, 4, 100, 44)
    need = 2 * (2 * d_fl + p_fl) + d_fl
    assert reader("eval_mfu_cheby")(ctx) == pytest.approx(
        need / (0.08 * peaks.PEAK_FP32_FLOPS) * 100.0)


def test_the_new_readers_read_nothing_without_their_sources():
    # the parent's program: no grape.taylor_pass span
    ctx = context(cheby_trace(spans=False))
    assert reader("taylor_pass_ms")(ctx) is None
    assert reader("taylor_roofline")(ctx) is None
    # the kernels still ran: the scan's roofline needs no span
    assert reader("cheby_roofline")(ctx) is not None
    # no scan kernel (another path, or the CPU)
    no_kernels = [e for e in cheby_trace() if e["cat"] != "kernel"
                  or "cheby" not in e["name"]]
    assert reader("cheby_roofline")(context(no_kernels)) is None
    device_free = [e for e in cheby_trace() if e["cat"] not in (
        "kernel", "gpu_memcpy")]
    for name in ("cheby_roofline", "taylor_pass_ms", "taylor_roofline"):
        assert reader(name)(context(device_free)) is None, name
    # a structure without the drift's spectral range (another kind)
    plain = {k: v for k, v in STRUCT.items()
             if k not in ("h0_range", "op_radii")}
    for name in ("cheby_roofline", "eval_mfu_cheby"):
        assert reader(name)(context(cheby_trace(), struct=plain)) is None
    # no evaluation in the slice, no recorder
    assert reader("cheby_roofline")(context(cheby_trace(), spans=[])) is None
    assert reader("taylor_roofline")(context(cheby_trace(), spans=[])) is None
    assert reader("eval_mfu_cheby")(context(cheby_trace())) is None
    ctx = context(cheby_trace())
    ctx.recorder = None
    for name in NEW:
        assert reader(name)(ctx) is None, name


def test_the_cells_entries():
    per_layer = {m["name"]: m for m in BENCH["per_layer"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    # the CZ group's rate and bound; the cell's own twins of its readings
    assert e2e["iters_per_s"]["workloads"] == ["cz.gradgen", "cz.taylor",
                                               CELL]
    assert [m["name"] for m in BENCH["end_to_end"]
            if CELL in m.get("workloads", [CELL])] == ["setup_s",
                                                       "iters_per_s"]
    mine = [m for m in BENCH["per_layer"] if CELL in m["workloads"]]
    assert len(mine) == 12
    for m in mine:
        assert m["workloads"] == [CELL] and m["name"].endswith(".cheby")
        assert m["moves"] == "iters_per_s"
    for base in NEW:
        assert per_layer[base + ".cheby"]
    # the propagators' yardsticks are not this path's
    for name in ("eval_mfu", "kernel_roofline"):
        assert CELL not in per_layer[name]["workloads"]


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_at_the_tiny_size(trace):
    line, _ = tiny.run(CELL, trace=trace)
    assert line["correct"] is True, line
    metrics = line["metrics"]
    if not trace:
        assert set(metrics) == {"setup_s", "iters_per_s"}
        return
    # on the CPU: the host's readings; nothing of the card's
    for name in ("loop_host_ms.cheby", "evals_per_iter.cheby",
                 "eval_ms.cheby", "lbfgsb_ms.cheby"):
        assert metrics[name]["value"] > 0, name
    for name in ("cheby_roofline.cheby", "taylor_pass_ms.cheby",
                 "taylor_roofline.cheby", "idle_eval.cheby"):
        assert name not in metrics, name
