"""The measured window: solves of the program back to back for a fixed
number of seconds, timed from the benchmark's side.

An iteration runs from the previous iteration's callback to its own: its
line-search evaluations and, for a solve's first iteration, the solve's
set-up (the workspace, ``compile_problem``) and its evaluation at the
guess.  The window opens when the first solve is called and closes at the
first callback past its seconds, through ``check_convergence``.  The
iterates that ``correct`` is judged on are kept as they pass (each
iteration's accepted iterate and each solve's guess): the last one, and a
sample drawn from the seed by reservoir sampling; each solve's J_T at its
guess; and the first solve's iterates up to ``path_iterations``, which the
check follows with the reference's own L-BFGS-B."""

import time

import numpy as np

__all__ = ["Window"]


class Window:
    def __init__(self, seconds, rng, n_random, path_iterations=0,
                 on_iteration=None):
        self.seconds = float(seconds)
        self.path_iterations = int(path_iterations)
        self.rng = rng
        self.n_random = int(n_random)
        self.on_iteration = on_iteration  # traced runs: the profiler slice
        self.iter_s = []        # wall seconds of each iteration
        self.iter_end = []      # perf_counter at each iteration's end
        self.excluded_s = 0.0   # time the harness itself spent (profiler)
        self.sampled = []       # reservoir of (j, record)
        self.n_offered = 0      # iterates seen, the guesses' included
        self.last = None
        self.J_T_guess = {}     # solve -> J_T at its guess
        self.path = {}          # iteration -> record, the first solve's
        self.solves = []
        self.closed = False
        self.t_start = self.t_mark = self.t_end = None

    def open(self):
        self.t_start = self.t_mark = time.perf_counter()

    @property
    def n_iters(self):
        return len(self.iter_s)

    @property
    def duration(self):
        return sum(self.iter_s)

    def callback(self, wrk, iteration):
        now = time.perf_counter()
        record = {
            "solve": len(self.solves), "iteration": int(iteration),
            "pulses": np.array(wrk.pulsevals, dtype=np.float64).reshape(
                len(wrk.controls), -1),
            "J_T": float(wrk.result.J_T),
            "gradient": np.array(wrk.gradient, dtype=np.float64),
        }
        self._offer(record)
        if not self.solves and iteration <= self.path_iterations:
            self.path[int(iteration)] = record
        if iteration == 0:  # the evaluation at the guess: not an iteration
            self.J_T_guess[len(self.solves)] = record["J_T"]
            return None
        self.iter_s.append(now - self.t_mark)
        self.iter_end.append(now)
        if self.on_iteration is not None:
            self.on_iteration(self, now)
            after = time.perf_counter()
            self.excluded_s += after - now
            now = after
        self.t_mark = now
        return None

    def _offer(self, record):
        """Keep ``record`` as the last iterate, and in the reservoir with
        the seed's probability."""
        j = self.n_offered
        self.n_offered += 1
        self.last = (j, record)
        if j < self.n_random:
            self.sampled.append((j, record))
        else:
            r = int(self.rng.integers(0, j + 1))
            if r < self.n_random:
                self.sampled[r] = (j, record)

    def check_convergence(self, result):
        if self.t_mark - self.t_start - self.excluded_s >= self.seconds:
            self.closed = True
            self.t_end = self.t_mark
            return True
        return False

    def records(self):
        """The checked iterates, the last one among them, in window
        order."""
        out = dict(self.sampled)
        if self.last is not None:
            out[self.last[0]] = self.last[1]
        return [out[j] for j in sorted(out)]
