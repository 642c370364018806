"""Optimization result object.

Python analog of ``GrapeResult`` (``src/result.jl:43-147``):
the mutable record updated once per optimizer iteration, holding iteration
bookkeeping, functional values (with previous-iteration values for
delta-columns), guess/optimized controls, final states, callback records, and
evaluation counters.  Also provides ``from_result`` for cross-method
continuation (the reference's ``Base.convert``) and dict/NPZ serialization
for checkpointing (the reference's JLD2 path via ``@optimize_or_load``).
"""

import datetime
import time

import numpy as np

__all__ = ["GrapeResult"]


class GrapeResult:
    def __init__(self, trajectories, tlist, kwargs):
        from .controls import discretize, get_controls

        self.tlist = np.asarray(tlist, dtype=np.float64)
        self.iter_start = int(kwargs.get("iter_start", 0))
        self.iter_stop = int(kwargs.get("iter_stop", 5000))
        self.iter = self.iter_start
        self.secs = 0.0
        self.tau_vals = np.zeros(len(trajectories), dtype=np.complex128)
        self.J_T = 0.0
        self.J_T_prev = 0.0
        self.J_a = 0.0
        self.J_a_prev = 0.0
        self.J_b = 0.0
        self.J_b_prev = 0.0
        controls = get_controls([t.generator for t in trajectories])
        self.guess_controls = [discretize(c, tlist) for c in controls]
        self.optimized_controls = [g.copy() for g in self.guess_controls]
        self.states = [np.asarray(t.initial_state) for t in trajectories]
        self.start_local_time = datetime.datetime.now()
        self.end_local_time = datetime.datetime.now()
        # time.perf_counter() at the last update: the origin of ``secs``
        self.clock_mark = time.perf_counter()
        self.records = []
        self.converged = False
        self.f_calls = 0
        self.fg_calls = 0
        self.message = "in progress"

    def __repr__(self):
        return f"GrapeResult<{self.message}>"

    def __str__(self):
        elapsed = self.end_local_time - self.start_local_time
        return (
            "GRAPE Optimization Result\n"
            "-------------------------\n"
            f"- Started at {self.start_local_time}\n"
            f"- Number of trajectories: {len(self.states)}\n"
            f"- Number of iterations: {max(self.iter - self.iter_start, 0)}\n"
            f"- Number of pure func evals: {self.f_calls}\n"
            f"- Number of func/grad evals: {self.fg_calls}\n"
            f"- Value of functional: {self.J_T:.5e}\n"
            f"- Reason for termination: {self.message}\n"
            f"- Ended at {self.end_local_time} ({elapsed})\n"
        )

    # -- serialization (checkpoint / @optimize_or_load analog) --------------

    def to_dict(self):
        return {
            "tlist": self.tlist,
            "iter_start": self.iter_start,
            "iter_stop": self.iter_stop,
            "iter": self.iter,
            "secs": self.secs,
            "tau_vals": np.asarray(self.tau_vals),
            "J_T": self.J_T,
            "J_T_prev": self.J_T_prev,
            "J_a": self.J_a,
            "J_a_prev": self.J_a_prev,
            "J_b": self.J_b,
            "J_b_prev": self.J_b_prev,
            "guess_controls": [np.asarray(c) for c in self.guess_controls],
            "optimized_controls": [
                np.asarray(c) for c in self.optimized_controls
            ],
            "states": [np.asarray(s) for s in self.states],
            "records": self.records,
            "converged": self.converged,
            "f_calls": self.f_calls,
            "fg_calls": self.fg_calls,
            "message": self.message,
        }

    @classmethod
    def from_result(cls, other, trajectories, tlist, kwargs):
        """Continuation constructor (``Base.convert(GrapeResult, r)`` analog,
        ``src/result.jl:137-147``): accept a result from GRAPE or another
        method, with defaults for missing fields."""
        res = cls(trajectories, tlist, kwargs)
        for attr in (
            "iter", "J_T", "J_T_prev", "tau_vals", "converged", "message",
        ):
            if hasattr(other, attr):
                setattr(res, attr, getattr(other, attr))
        for attr in ("J_a", "J_a_prev", "J_b", "J_b_prev", "f_calls",
                     "fg_calls"):
            setattr(res, attr, getattr(other, attr, 0.0 if "J" in attr else 0))
        if hasattr(other, "optimized_controls"):
            res.optimized_controls = [
                np.asarray(c).copy() for c in other.optimized_controls
            ]
        if hasattr(other, "states"):
            res.states = [np.asarray(s) for s in other.states]
        if hasattr(other, "records"):
            res.records = list(other.records)
        return res
