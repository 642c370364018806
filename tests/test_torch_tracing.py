"""The port's ``grape.*`` spans (``grape_tpu_torch.tracing``): the tree that
``optimize(..., profile_dir=...)`` exports, one ``grape.update_result`` and
one ``grape.callback`` an iteration, one ``grape.segment`` per recompute
segment of each backward pass, the co-state chain and the Taylor pass
apart inside it; no ``record_function`` at all while no
profiler records; J, the gradient and the iterates bit for bit the same
with the profiler on or off; spans that straddle the profiler's start or
stop; and ``GrapeResult.secs`` on the monotonic clock."""

import datetime
import importlib
import json
import os
import time
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import grape_tpu_torch as gt
from grape_tpu_torch import tracing
from grape_tpu_torch.models import (
    two_transmon_cz_ensemble_problem, two_transmon_cz_problem,
)

# the module (the package's ``optimize`` is the function)
port_optimize = importlib.import_module("grape_tpu_torch.optimize")

torch.set_num_threads(1)

ITERS = 3
SEGMENTS = 3

CASES = {
    # a CZ gate at d = 3 under full storage, and a 2-sample ensemble under
    # recompute storage in three segments
    "gradgen_full": (lambda: two_transmon_cz_problem(d=3, n_steps=40,
                                                     T=10.0),
                     dict(gradient_method="gradgen", storage_mode="full")),
    "recompute": (lambda: two_transmon_cz_ensemble_problem(
        n_samples=2, d=3, n_steps=60, T=10.0),
        dict(storage_mode="recompute", storage_segments=SEGMENTS)),
    # the CZ under Chebyshev propagation with the time-vectorized Taylor
    # gradient: the co-state chain and the pass apart
    "cheby_taylor": (lambda: two_transmon_cz_problem(d=3, n_steps=40,
                                                     T=10.0),
                     dict(prop_method="cheby", gradient_method="taylor",
                          storage_mode="full")),
}

EVALUATIONS = ("grape.evaluate_gradient", "grape.evaluate_functional")
# each span's innermost enclosing ``grape.*`` span
PARENTS = {
    "grape.solve": (None,),
    "grape.setup": ("grape.solve",),
    "grape.lbfgsb": ("grape.solve",),
    "grape.update_result": ("grape.solve",),
    "grape.callback": ("grape.solve",),
    "grape.finalize": ("grape.solve",),
    "grape.evaluate_gradient": ("grape.solve",),
    "grape.evaluate_functional": ("grape.solve",),
    "grape.envelope": EVALUATIONS,
    "grape.build_programs": ("grape.setup", "grape.envelope"),
    "grape.dispatch": EVALUATIONS,
    "grape.readback": EVALUATIONS,
    "grape.coefficients": ("grape.dispatch",),
    "grape.forward": ("grape.dispatch",),
    "grape.boundary": ("grape.dispatch",),
    "grape.backward": ("grape.dispatch",),
    "grape.assemble": ("grape.dispatch",),
    "grape.segment": ("grape.backward",),
    "grape.costates": ("grape.backward", "grape.segment"),
    "grape.taylor_pass": ("grape.backward", "grape.segment"),
}


def _solve(case, callback=None, **kw):
    """``(result, [(iteration, J_T, gradient, pulses)])`` of one solve of
    ``case``, recorded in the callback (after ``callback``, if given)."""
    make, options = CASES[case]
    seen = []

    def record(wrk, it):
        seen.append((it, float(wrk.result.J_T), np.array(wrk.gradient),
                     np.array(wrk.pulsevals)))

    callbacks = [record] if callback is None else [callback, record]
    res = gt.optimize_problem(make(), iter_stop=ITERS, device="cpu",
                              print_iters=False, rethrow_exceptions=True,
                              callback=callbacks, **options, **kw)
    return res, seen


def _trace(path):
    files = [f for f in os.listdir(path) if f.endswith(".json")]
    assert len(files) == 1
    with open(os.path.join(path, files[0])) as fh:
        return json.load(fh)["traceEvents"]


def _spans(events):
    """The ``grape.*`` complete events as ``(name, start, end)``, each with
    the name of its innermost enclosing ``grape.*`` span."""
    spans = sorted(((e["name"], float(e["ts"]), float(e["ts"]) + e["dur"])
                    for e in events if e.get("ph") == "X"
                    and str(e.get("name", "")).startswith("grape.")),
                   key=lambda s: (s[1], -s[2]))
    out, stack = [], []
    for name, a, b in spans:
        while stack and a >= stack[-1][2] - 1e-3:
            stack.pop()
        assert not stack or b <= stack[-1][2] + 1e-3, (name, stack[-1])
        out.append((name, a, b, stack[-1][0] if stack else None))
        stack.append((name, a, b))
    return out


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """Each case solved once under ``profile_dir``: its result, its
    records and its spans."""
    out = {}
    for case in CASES:
        path = tmp_path_factory.mktemp(case)
        res, seen = _solve(case, profile_dir=str(path))
        out[case] = (res, seen, _spans(_trace(path)))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_the_trace_has_the_span_tree(traced, case):
    res, _, spans = traced[case]
    assert res.iter == ITERS
    names = Counter(name for name, *_ in spans)
    assert names["grape.solve"] == names["grape.setup"] == 1
    assert names["grape.finalize"] == 1
    for name, _, _, parent in spans:
        assert parent in PARENTS[name], (name, parent)
    evals = names["grape.evaluate_gradient"] + names[
        "grape.evaluate_functional"]
    assert evals == res.fg_calls + res.f_calls
    for stage in ("grape.envelope", "grape.dispatch", "grape.readback",
                  "grape.coefficients", "grape.forward", "grape.boundary"):
        assert names[stage] == evals, stage
    assert names["grape.backward"] == names["grape.assemble"] == (
        names["grape.evaluate_gradient"])
    # each L-BFGS-B task: one step call before each evaluation, one before
    # each new iterate
    assert names["grape.lbfgsb"] >= evals + ITERS
    # the solve spans every other span
    solve = [s for s in spans if s[0] == "grape.solve"][0]
    assert all(solve[1] <= a and b <= solve[2] + 1e-3
               for _, a, b, _ in spans)


@pytest.mark.parametrize("case", list(CASES))
def test_one_update_and_one_callback_an_iteration(traced, case):
    res, seen, spans = traced[case]
    names = Counter(name for name, *_ in spans)
    # the guess's evaluation (iteration 0) and each iteration after it
    assert len(seen) == ITERS + 1
    assert names["grape.update_result"] == names["grape.callback"] == (
        ITERS + 1)


@pytest.mark.parametrize("case", list(CASES))
def test_segments_of_each_backward_pass(traced, case):
    _, _, spans = traced[case]
    per_pass = Counter(
        next(i for i, (n, a0, b0, _) in enumerate(spans)
             if n == "grape.backward" and a0 <= a and b <= b0 + 1e-3)
        for name, a, b, _ in spans if name == "grape.segment")
    passes = [i for i, s in enumerate(spans) if s[0] == "grape.backward"]
    expected = SEGMENTS if case == "recompute" else 0
    assert [per_pass.get(i, 0) for i in passes] == [expected] * len(passes)


@pytest.mark.parametrize("case", list(CASES))
def test_the_costates_and_the_taylor_pass_apart(traced, case):
    """Each window's co-state chain is a ``grape.costates`` span of its
    own; under the Taylor gradient the vectorized pass that follows it is a
    ``grape.taylor_pass``, after it and inside the same backward pass."""
    _, _, spans = traced[case]
    names = Counter(name for name, *_ in spans)
    windows = SEGMENTS if case == "recompute" else 1
    assert names["grape.costates"] == windows * names["grape.backward"]
    taylor = CASES[case][1].get("gradient_method") == "taylor"
    assert names["grape.taylor_pass"] == (names["grape.costates"] if taylor
                                          else 0)
    if taylor:
        chains = [s for s in spans if s[0] == "grape.costates"]
        passes = [s for s in spans if s[0] == "grape.taylor_pass"]
        for (_, a0, b0, p0), (_, a1, b1, p1) in zip(chains, passes):
            assert p0 == p1 == "grape.backward" and b0 <= a1 + 1e-3


@pytest.mark.parametrize("case", list(CASES))
def test_no_profiler_no_record_function(monkeypatch, case):
    def refuse(name, *args, **kwargs):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not tracing.profiling()
    res, seen = _solve(case)
    assert res.iter == ITERS and len(seen) == ITERS + 1


@pytest.mark.parametrize("case", list(CASES))
def test_bit_identical_with_the_profiler_on_and_off(traced, case):
    res_on, seen_on, _ = traced[case]
    res_off, seen_off = _solve(case)
    assert len(seen_on) == len(seen_off)
    for (i0, J0, g0, x0), (i1, J1, g1, x1) in zip(seen_on, seen_off):
        assert i0 == i1 and J0 == J1
        assert np.array_equal(g0, g1) and np.array_equal(x0, x1)
    assert res_on.J_T == res_off.J_T
    assert (res_on.fg_calls, res_on.f_calls) == (res_off.fg_calls,
                                                 res_off.f_calls)
    for c0, c1 in zip(res_on.optimized_controls, res_off.optimized_controls):
        assert np.array_equal(c0, c1)


def test_a_callers_profiler_stopped_in_the_callback(tmp_path):
    """A caller that starts and stops its own profiler in its callback (as
    the benchmark does) gets the evaluations and the loop's steps, and no
    span that encloses its hooks: none is open at the stop, where the
    profiler would export it with the end of its own post-processing."""
    prof = profile(activities=[ProfilerActivity.CPU])

    def slice_(wrk, it):
        if it == 1:
            prof.start()
        elif it == 2:
            prof.stop()

    res, _ = _solve("gradgen_full", callback=slice_)
    assert res.iter == ITERS and not tracing.profiling()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    last = max(float(e["ts"]) + float(e["dur"]) for e in events)
    names = Counter(e["name"] for e in events
                    if e["name"].startswith("grape."))
    assert names["grape.evaluate_gradient"] >= 1 and names["grape.lbfgsb"]
    assert names["grape.update_result"] == 1
    assert not names["grape.solve"] and not names["grape.callback"]
    assert all(float(e["ts"]) + float(e["dur"]) < last for e in events
               if e["name"].startswith("grape."))


def test_span_is_shared_and_inert_without_a_profiler():
    assert not tracing.profiling()
    a, b = tracing.span("grape.a"), tracing.span("grape.b")
    assert a is b
    with a:
        with b:
            pass


@pytest.mark.parametrize("where", ["before_start", "open_at_stop"])
def test_spans_that_straddle_the_profiler(tmp_path, where):
    prof = profile(activities=[ProfilerActivity.CPU])
    if where == "before_start":
        with tracing.span("grape.early"):  # entered with no profiler
            prof.start()
            with tracing.span("grape.inner"):
                torch.ones(3).sum()
        prof.stop()
    else:
        prof.start()
        with tracing.span("grape.inner"):
            torch.ones(3).sum()
        late = tracing.span("grape.late")
        late.__enter__()
        prof.stop()
        late.__exit__(None, None, None)  # closes cleanly after the stop
    assert not tracing.profiling()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    names = {e["name"] for e in events}
    assert "grape.inner" in names
    if where == "before_start":
        assert "grape.early" not in names
    else:
        # exported clipped at the stop: its end is the trace's last end,
        # which is how the benchmark's span readers leave it out
        late = [e for e in events if e["name"] == "grape.late"]
        last = max(float(e["ts"]) + float(e["dur"]) for e in events)
        assert len(late) == 1
        assert float(late[0]["ts"]) + float(late[0]["dur"]) == last


def test_secs_is_on_the_monotonic_clock(monkeypatch):
    """``secs`` comes from ``time.perf_counter``: a wall clock that steps
    back an hour at every reading (a clock being set) leaves it at the
    iteration's real duration."""

    class SteppingBack(datetime.datetime):
        t = datetime.datetime(2030, 1, 1)

        @classmethod
        def now(cls, tz=None):
            cls.t -= datetime.timedelta(hours=1)
            return cls.t

    monkeypatch.setattr(port_optimize, "datetime",
                        type("clock", (), {"datetime": SteppingBack}))
    marks, stamps, secs = [], [], []

    def record(wrk, it):
        marks.append(time.perf_counter())
        stamps.append(wrk.result.clock_mark)
        secs.append(wrk.result.secs)

    t0 = time.perf_counter()
    gt.optimize_problem(CASES["gradgen_full"][0](), iter_stop=ITERS,
                        device="cpu", print_iters=False,
                        rethrow_exceptions=True, callback=record)
    assert len(secs) == ITERS + 1
    assert t0 < stamps[0] <= marks[0]
    for k in range(1, ITERS + 1):
        # stamped at the iteration's update, before its callback
        assert marks[k - 1] < stamps[k] <= marks[k]
        assert secs[k] == stamps[k] - stamps[k - 1] > 0.0
