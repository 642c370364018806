"""What a traced run (``--trace 1``) records, all from the benchmark's side.

- Evaluation spans: the host clock around ``GrapeWrk.evaluate_gradient``
  and ``evaluate_functional`` (both return their value to the host, which
  waits for the card), each with the largest pulse value of each control
  that it evaluated.
- Kernel calls: the arguments of the program's launch wrappers of the
  hand-written kernels (``hopper_prop.propagators``, ``hopper_prop.
  _state_scan``, ``hopper_frechet._frechet_trace``) while the profiler
  runs, so that each call's operations and bytes can be counted.
- One profiled slice of the window (``torch.profiler``, host and card),
  exported to a Chrome trace under ``TMPDIR``, read back and deleted.

A wrapper that cannot be found or read leaves its records empty, and the
metrics that need them read nothing."""

import functools
import inspect
import json
import os
import tempfile
import time

import numpy as np

__all__ = ["Recorder"]


def _shape_of(kind, a):
    """The counted parameters of one launch-wrapper call, from its bound
    arguments ``a``."""
    if kind == "propagators":
        return {"G": int(a["H0"].shape[0]), "T": int(a["ops"].shape[1]),
                "d": int(a["ops"].shape[-1]), "N_T": int(a["dts"].shape[0]),
                "coeff_values": int(a["coeffs"].numel()),
                "s": int(a["n_squarings"])}
    if kind == "state_scan":
        U, x0 = a["U"], a["x0"]
        return {"C": int(U.shape[0]), "G": int(U.shape[1]),
                "K": int(x0.shape[0]), "d": int(x0.shape[1]),
                "chi": bool(a["chi"]), "carry": a["x_out"] is not None}
    if kind == "frechet":
        return {"G": int(a["ops"].shape[0]), "T": int(a["ops"].shape[1]),
                "d": int(a["ops"].shape[-1]), "N_T": int(a["dts"].shape[0]),
                "K": int(a["psis"].shape[1]),
                "coeff_values": int(a["coeffs"].numel()),
                "s": int(a["n_squarings"])}
    raise ValueError(kind)


class Recorder:
    """Spans, kernel calls and the profiled slice of one traced run."""

    def __init__(self, slice_plan, seconds):
        self.plan = slice_plan
        self.seconds = float(seconds)
        self.spans = []          # (t0, t1, kind, amplitudes)
        self.kernel_calls = []   # (kind, shape) while the profiler runs
        self.events = None       # the slice's Chrome trace events
        self.slice = None        # (t0, t1) perf_counter of the slice
        self._prof = None
        self._recording = False
        self._slice_iters = 0
        self._undo = []

    # -- wrappers around the program's calls ------------------------------

    def install(self):
        from grape_tpu_torch import workspace
        from grape_tpu_torch.ops import hopper_frechet, hopper_prop

        self._wrap(workspace.GrapeWrk, "evaluate_gradient", self._span)
        self._wrap(workspace.GrapeWrk, "evaluate_functional", self._span)
        self._wrap(hopper_prop, "propagators", self._kernel("propagators"))
        self._wrap(hopper_prop, "_state_scan", self._kernel("state_scan"))
        self._wrap(hopper_frechet, "_frechet_trace", self._kernel("frechet"))

    def uninstall(self):
        for owner, name, fn in reversed(self._undo):
            setattr(owner, name, fn)
        self._undo = []

    def _wrap(self, owner, name, make):
        fn = getattr(owner, name, None)
        if fn is None:
            return
        setattr(owner, name, make(fn, name))
        self._undo.append((owner, name, fn))

    def _span(self, fn, name):
        rec = self

        @functools.wraps(fn)
        def wrapped(wrk, x, *args, **kwargs):
            from torch.profiler import record_function

            amps = np.max(np.abs(np.reshape(np.asarray(x),
                                            (len(wrk.controls), -1))), axis=1)
            t0 = time.perf_counter()
            with record_function("bench.evaluation"):
                out = fn(wrk, x, *args, **kwargs)
            rec.spans.append((t0, time.perf_counter(), name, amps))
            return out

        return wrapped

    def _kernel(self, kind):
        def make(fn, name):
            rec = self
            sig = inspect.signature(fn)

            @functools.wraps(fn)
            def wrapped(*args, **kwargs):
                if rec._recording:
                    try:
                        bound = sig.bind(*args, **kwargs).arguments
                        rec.kernel_calls.append((kind,
                                                 _shape_of(kind, bound)))
                    except Exception:  # an unreadable call: count nothing
                        rec.kernel_calls.append((kind, None))
                return fn(*args, **kwargs)

            return wrapped

        return make

    # -- the profiled slice -------------------------------------------------

    def on_iteration(self, window, now):
        """Called at each iteration's end: starts the slice at its share of
        the window, stops it once it has lasted its seconds and its
        iterations."""
        import torch

        if self.slice is None and self._prof is None:
            if now - window.t_start >= self.plan["start_share"] * self.seconds:
                from torch.profiler import ProfilerActivity, profile

                activities = [ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    activities.append(ProfilerActivity.CUDA)
                self._prof = profile(activities=activities)
                self._prof.start()
                self._recording = True
                self._t0 = time.perf_counter()
                self._slice_iters = 0
            return
        if self._recording:
            self._slice_iters += 1
            if (now - self._t0 >= self.plan["seconds"]
                    and self._slice_iters >= self.plan["min_iterations"]):
                self.stop(torch)

    def stop(self, torch=None):
        if not self._recording:
            return
        if torch is None:
            import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._recording = False
        self.slice = (self._t0, time.perf_counter())
        self._prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_slice_")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as fh:
                self.events = json.load(fh).get("traceEvents", [])
        finally:
            os.remove(path)
        self._prof = None
