"""One run of one cell: set-up, the measured window, the per-layer
readings of a traced run, and the check against the reference.  Returns
the result line and the lines that report each compared number beside its
limit.  The per-layer readers get a namespace of the window, the traced
run's recorder, the traffic, the counted structure of the problem (one
card's share of it) and the window's peak memory.

On several cards each rank runs this in lockstep (``ranks``): the same
set-up, warm-up and solves, each solve sharded over the mesh; rank 0 alone
times, profiles and checks, and returns the line, the others ``(None,
None)``."""

import gc
import importlib.util
import math
import os
import statistics
import time
from types import SimpleNamespace

import numpy as np

from . import check, inputs, spec
from .breakdown import breakdown as make_breakdown
from .ranks import FORBIDDEN, RankedReference, Solo, card_share
from .tracing import Recorder
from .window import Window

__all__ = ["run", "FORBIDDEN"]



def base_name(name):
    """What a metric's name names before its first dot: the quantity that
    its reader (``metrics/<base>.py``) reads.  One quantity reported in
    cells that report different end-to-end metrics takes one name for each
    (``eval_ms`` and ``eval_ms.ensemble``), and one reader."""
    return name.split(".")[0]


def _load_reader(name):
    base = base_name(name)
    path = os.path.join(spec.BENCH_DIR, "metrics", base + ".py")
    mod_name = "benchmark.metrics." + base
    module_spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module.read


def _solve(gt, problem, traffic, window, device, dtype, iter_stop,
           mesh=None):
    options = dict(traffic["options"])
    if mesh is not None:
        options["mesh"] = mesh
    if traffic.get("bounds") is not None:
        options["lower_bound"] = -float(traffic["bounds"])
        options["upper_bound"] = float(traffic["bounds"])
    kwargs = {}
    if window is not None:
        kwargs = {"callback": window.callback,
                  "check_convergence": window.check_convergence}
    return gt.optimize_problem(
        problem, optimizer=traffic.get("optimizer", "auto"),
        iter_stop=iter_stop, print_iters=False,
        device=device, dtype=dtype, **options, **kwargs)


def run(name, seed, seconds, trace, device="cuda", t0=None, config=None,
        dtype=None, control=False, t_torch=None, ranks=None):
    """One run of cell ``name``.  ``config`` replaces the cell's
    configuration (the CPU tests' small sizes), ``dtype`` the
    configuration's (complex128 on the CPU).  ``control``: also put the
    reference in the program's place, computed in complex64 with TF32
    products (at the same iterates, and along its own L-BFGS-B path), and
    report its numbers under ``control`` (the check's control; never in
    the benchmark's runs).  ``t0``: when the process started; ``t_torch``:
    when its import of torch ended (the set-up's parts report both).
    ``ranks``: this process's place among the ranks of a cell on several
    cards (``ranks.Group``, not yet connected); None: one card."""
    t0 = time.perf_counter() if t0 is None else t0
    ranks = ranks or Solo()
    marks = [("start", time.perf_counter())]
    import torch

    import grape_tpu_torch as gt
    from benchmark import programs, reference

    marks.append(("imports", time.perf_counter()))
    sp = spec.cell_spec(name)
    config = config or sp["config"]
    traffic, cell_check = sp["traffic"], sp["check"]
    limits = cell_check["limits"]
    dtype = dtype or getattr(np, config["dtype"])
    cuda = torch.device(device).type == "cuda"
    if cuda:
        from grape_tpu_torch.ops import _build

        _build.load_kernels()
    marks.append(("kernels", time.perf_counter()))
    ranks.connect(device)
    if ranks.world > 1:
        marks.append(("join", time.perf_counter()))

    # set-up: the inputs, the operators, one short solve on the cell's shapes
    raw = inputs.draw(config, seed)
    program = programs.load(config["kind"]).Program(config, raw)
    structure = card_share(program.structure(), ranks.world)
    marks.append(("inputs", time.perf_counter()))
    _solve(gt, program.problem(inputs.warmup_guess(config, traffic, seed)),
           traffic, None, device, dtype, int(traffic["warmup_iter_stop"]),
           ranks.mesh)
    setup_peak = None
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    marks.append(("warmup", time.perf_counter()))
    recorder = None
    n_random = int(cell_check["checked_iterates"]["random"])
    path_iterations = int(cell_check.get("path_iterations", 0))
    window = Window(seconds, inputs.rng(seed, 5), n_random, path_iterations,
                    decide=ranks.decide)
    if trace and ranks.lead:
        recorder = Recorder(cell_check["trace_slice"], seconds)
        recorder.install()
        window.on_iteration = recorder.on_iteration
    ranks.barrier()  # the window opens once the slowest rank is ready
    if ranks.world > 1:
        marks.append(("ranks_ready", time.perf_counter()))
    setup_s = time.perf_counter() - t0
    setup_parts = ([("before", marks[0][1] - t0)] if t_torch is None else
                   [("torch", t_torch - t0), ("look", marks[0][1] - t_torch)])
    setup_parts += [(b[0], b[1] - a[1]) for a, b in zip(marks, marks[1:])]

    # the window
    window.open()
    i = 0
    while not window.closed:
        res = _solve(gt, program.problem(inputs.guess(config, traffic, seed,
                                                      i)),
                     traffic, window, device, dtype,
                     int(traffic["solve_iter_stop"]), ranks.mesh)
        window.solves.append({"iterations": int(res.iter),
                              "fg_calls": int(res.fg_calls),
                              "f_calls": int(res.f_calls),
                              "J_T": float(res.J_T),
                              "J_T_guess": window.J_T_guess.get(i),
                              "message": str(res.message)})
        i += 1
        now = time.perf_counter()
        if not window.closed and window.decide(
                now - window.t_start - window.excluded_s >= seconds, (i, -1),
                wait=True):
            window.closed, window.t_end = True, now
    if recorder is not None:
        recorder.stop()
        recorder.uninstall()
    window_peak = None
    if cuda:
        torch.cuda.synchronize()
        window_peak = torch.cuda.max_memory_allocated()
    window_s = window.t_end - window.t_start - window.excluded_s
    failed = sum(s["message"].startswith("Exception")
                 for s in window.solves)
    records = window.records()
    # what every rank saw, on rank 0: its checked iterates, its solves and
    # its card's peak
    states = ranks.gather({
        "records": records,
        "solves": [(s["iterations"], s["J_T"], s["message"])
                   for s in window.solves],
        "peak": int(max(setup_peak or 0, window_peak or 0)),
        "cores": sorted(os.sched_getaffinity(0))})

    # the metrics, each reported under every name of its quantity that the
    # cell has
    metrics = {}
    if ranks.lead and not trace:
        values = {"setup_s": setup_s,
                  "iters_per_s": window.n_iters / window_s}
        if len(window.iter_s) >= 2:
            values["iter_ms_p95"] = 1e3 * statistics.quantiles(
                window.iter_s, n=100, method="inclusive")[94]
        for m in sp["end_to_end"]:
            if base_name(m["name"]) in values:
                metrics[m["name"]] = {"value": values[base_name(m["name"])],
                                      "unit": m["unit"]}
    ctx = SimpleNamespace(window=window, recorder=recorder, traffic=traffic,
                          structure=structure,
                          window_peak_bytes=window_peak)
    if ranks.lead and trace:
        for m in sp["per_layer"]:
            v = _load_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if cuda
                            else "cpu"),
                   "count": ranks.world,
                   "memory_peak_bytes": (max(st["peak"] for st in states)
                                         if ranks.lead else None)}
    breakdown = None
    if trace and recorder is not None and recorder.events:
        breakdown, busy_s, span_s = make_breakdown(recorder.events)
        device_info["busy_s"] = busy_s
        device_info["window_s"] = span_s

    # the check, with the program's state freed; on several cards each
    # rank computes the reference on its block of the samples
    path_at = min(path_iterations, max(window.path, default=0))
    path = window.path.get(path_at) if path_at else None
    guess0 = inputs.guess(config, traffic, seed, 0)
    del ctx, recorder, program
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    kind = reference.load(config["kind"])

    def with_reference(use, **kwargs):
        """``use(reference)`` on rank 0, the reference's blocks served by
        the others."""
        ref = RankedReference(kind, config, raw, device, ranks, **kwargs)
        if not ranks.lead:
            ref.serve()
            return None
        try:
            return use(ref)
        finally:
            ref.close()

    def numbers_of(recs, own_path, gap):
        def use(ref):
            numbers = dict(check.compare(ref, recs),
                           J_T_rise=check.rise(window.solves), rank_gap=gap)
            if path_iterations:
                numbers.update(check.path_gaps(
                    check.lbfgsb_path(ref.value_and_grad, guess0,
                                      traffic.get("bounds"), path_at)
                    if path is not None else None, own_path, guess0))
            return numbers
        return with_reference(use)

    t_check = time.perf_counter()
    numbers = numbers_of(records, (path["J_T"], path["pulses"])
                         if path is not None else None,
                         check.rank_gap(states) if ranks.lead else None)
    check_s = time.perf_counter() - t_check
    control_numbers = None
    if control:
        def control_run(ctl):
            ctl_records = []
            for rec in records:
                J, g = ctl.value_and_grad(rec["pulses"])
                ctl_records.append(dict(rec, J_T=J, gradient=g))
            ctl_path = None
            if path is not None:
                ctl_path = check.lbfgsb_path(ctl.value_and_grad, guess0,
                                             traffic.get("bounds"), path_at)
            return ctl_records, ctl_path

        ctl_out = with_reference(control_run, dtype=torch.complex64,
                                 tf32=True)
        # TF32 was the control's; the reference turns it off again
        ctl_records, ctl_path = ctl_out or (None, None)
        control_numbers = numbers_of(ctl_records, ctl_path, 0.0)
    if not ranks.lead:
        return None, None
    correct = (check.passes(numbers, limits) and failed == 0
               and bool(records))
    line = {"correct": bool(correct), "attempted": len(window.solves),
            "failed": int(failed), "metrics": metrics, "device": device_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    if control_numbers is not None:
        line["control"] = control_numbers
    line["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                      for k in limits}
    lines = ["setup_parts " + " ".join(f"{k}_s {v!r}"
                                       for k, v in setup_parts)]
    lines.append("solves " + "; ".join(
        f"{s['iterations']} it, {s['fg_calls'] + s['f_calls']} evals, "
        f"J_T {s['J_T_guess'] if s['J_T_guess'] is not None else math.nan:.4e}"
        f" -> {s['J_T']:.4e}, {s['message']}" for s in window.solves))
    if ranks.world > 1:
        sync = ranks.sync_times()
        lines.append(
            f"ranks {ranks.world} peaks "
            + " ".join(str(st["peak"]) for st in states)
            + " cores " + " ".join(",".join(map(str, st["cores"]))
                                   for st in states)
            + f" decisions {len(sync)} decision_ms_mean "
            f"{1e3 * statistics.fmean(sync) if sync else math.nan!r} "
            f"decision_ms_min {1e3 * min(sync, default=math.nan)!r} "
            f"decision_ms_max {1e3 * max(sync, default=math.nan)!r}")
    lines.append(f"checked_iterates {len(records)} path_iterations "
                 f"{path_at} solves {len(window.solves)} failed {failed} "
                 f"iterations {window.n_iters} window_s {window_s!r} "
                 f"check_s {check_s!r}")
    lines += [f"{k} {numbers[k]!r} limit {limits[k]!r}" for k in limits]
    return line, lines
