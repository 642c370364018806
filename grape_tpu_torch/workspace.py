"""GRAPE workspace.

Counterpart of ``grape_tpu/workspace.py`` (the analog of GRAPE.jl's
``GrapeWrk``), holding the mutable host-side optimization state around the
purely-functional device evaluation: the flat pulse vector (layout
``pulsevals[l*N_T + n]``), gradient buffers, bounds, evaluation counters,
the result object, and optimizer-introspection state (step width, search
direction) for callbacks.

The pulse vector is simply the argument of ``fg``; mutation by the optimizer
(or by a callback) is honored because every evaluation passes the current
vector to the device.

Trajectories whose own propagator settings differ are partitioned first
(``fg_hetero.traj_prop_partition``) and compiled into one problem per
partition (``fg_hetero.compile_heterogeneous``), as the reference's
workspace does.  After each evaluation the ``fw_prop_callback`` (if any)
receives the per-step observables.  ``eval_device_calls > 1`` builds every
bucket's ``fg`` with ``fg.build_fg_multicall`` (its backward pass in that
many blocks; the same arithmetic as ``build_fg``), as the reference does.
``prewarm_envelope`` is accepted as ``True`` or ``False`` and has no
effect: the reference's prewarm thread builds the next envelope bucket's
programs in the background to hide its TPU's compile queue, and the port
compiles nothing when a bucket grows (building one is ``build_fg``'s host
work, which no thread needs to hide).  Device-argument builds are left out,
as a workaround of the TPU platform the port does not have.

``mesh=`` (a ``DeviceMesh`` of ``parallel.make_mesh`` or
``make_host_chip_mesh``) shards the compiled problem ONCE
(``parallel.shard_problem``): this rank's block of trajectories, every
envelope bucket's ``fg`` / ``f`` built sharded over it.  The backends run on
every rank on the same reduced ``(J, grad)``, so their iterates, and the
envelope decisions (host numpy on the replicated pulse), agree bit for bit.
``max_embedded_constant_bytes`` is accepted and has no effect: in the
reference it puts the operator arrays of a large problem into device
memory as program arguments on a one-device mesh, to get past its compile
server's request limit, and the port always holds them in device memory
(``fg._device_constants``); it opens no process group.

The host backends evaluate through ``evaluate_gradient`` /
``evaluate_functional``, which copy each evaluation's results into numpy
arrays.  The device-resident loop (``optimizer="device-lbfgs"``,
``device_loop_iters``) calls the raw programs ``wrk.fg`` / ``wrk.f`` of the
current envelope bucket on device tensors instead, and keeps the bucket
with ``_outside_envelope``, ``_ensure_envelope`` and ``_grow_envelope``.
"""

import numpy as np

from .controls import discretize_on_midpoints
from .fg import (
    build_f, build_fg, build_fg_multicall, compile_problem,
    uses_static_envelope,
)
from .fg_hetero import compile_heterogeneous, traj_prop_partition
from .parallel import shard_problem
from .result import GrapeResult
from .tracing import span

__all__ = [
    "GrapeWrk", "step_width", "search_direction", "norm_search",
    "gradient", "pulse_update", "vec_angle",
]

# keywords that optimize() and the workspace consume themselves, not
# compile_problem
_OPTIMIZE_KEYS = frozenset({
    "callback", "check_convergence", "iter_start", "iter_stop",
    "continue_from", "verbose", "rethrow_exceptions", "print_iters",
    "print_iter_info", "store_iter_info", "lbfgsb_m", "lbfgsb_factr",
    "lbfgsb_pgtol", "lbfgsb_iprint", "optimizer", "upper_bound",
    "lower_bound", "pulse_options", "check", "atexit_filename",
    "atexit_config_digest", "profile_dir", "device_loop_iters", "f_tol",
    "g_tol", "x_tol", "show_trace", "scipy_options", "allow_f_increases",
    "mesh", "eval_device_calls",
})

# keywords of grape_tpu.optimize() that have nothing to do here (see the
# module docstring)
_NO_EFFECT_KEYS = frozenset({"max_embedded_constant_bytes",
                             "prewarm_envelope"})


def _compile_kwargs(kwargs):
    """The subset of ``optimize`` keywords that ``compile_problem`` takes
    (an unknown one goes on, and ``compile_problem`` raises ``TypeError``
    for it)."""
    return {key: val for key, val in kwargs.items()
            if key not in _OPTIMIZE_KEYS and key not in _NO_EFFECT_KEYS}


def _to_numpy(x, dtype=None):
    arr = x.detach().cpu().numpy()
    return arr if dtype is None else arr.astype(dtype)


class GrapeWrk:
    def __init__(self, trajectories, tlist, kwargs):
        self.kwargs = dict(kwargs)
        self.trajectories = list(trajectories)
        self.tlist = np.asarray(tlist, dtype=np.float64)
        compile_kwargs = _compile_kwargs(self.kwargs)
        partition = traj_prop_partition(self.trajectories, compile_kwargs)
        if partition is not None:
            # per-trajectory propagator settings that differ: one compiled
            # problem per partition, the functional assembled over all
            self.cp = compile_heterogeneous(
                self.trajectories, tlist, partition, **compile_kwargs
            )
        else:
            self.cp = compile_problem(trajectories, tlist, **compile_kwargs)
        self.eval_device_calls = int(self.kwargs.get("eval_device_calls",
                                                     1))
        self.mesh = self.kwargs.get("mesh", None)
        if self.mesh is not None:
            # this rank's block; the builds below run sharded over the mesh
            self.cp = shard_problem(self.cp, self.mesh)
        self.controls = self.cp.controls
        L, N_T = self.cp.n_controls, self.cp.n_timesteps
        self.n = L * N_T

        # bounds (flat, same l-major layout as pulsevals) — built before
        # the envelope bucketing, which uses them as per-control caps
        ub = float(self.kwargs.get("upper_bound", np.inf))
        lb = float(self.kwargs.get("lower_bound", -np.inf))
        self.upper_bounds = np.full(self.n, ub)
        self.lower_bounds = np.full(self.n, lb)
        pulse_options = self.kwargs.get("pulse_options", None)
        if pulse_options:
            for l, control in enumerate(self.controls):
                options = None
                for key, val in pulse_options.items():
                    if key is control:
                        options = val
                        break
                if options is None:
                    continue
                sl = slice(l * N_T, (l + 1) * N_T)
                if "upper_bounds" in options:
                    self.upper_bounds[sl] = np.asarray(
                        options["upper_bounds"], dtype=np.float64
                    )
                if "lower_bounds" in options:
                    self.lower_bounds[sl] = np.asarray(
                        options["lower_bounds"], dtype=np.float64
                    )

        # Amplitude-envelope bucketing: the squaring count of the kernels
        # and of the chunked Fréchet pass and the static order count of the
        # vectorized Taylor pass are derived from the envelope.
        # Controls with FINITE box bounds use the bound itself as the
        # envelope (pulses can never exceed it); unbounded controls get a
        # power-of-two bucket that grows only when the optimizer pushes a
        # pulse beyond it.  The policy is the reference's, so the count
        # equals the reference's for the same pulse; here it is a runtime
        # integer handed to the kernels, so growing the bucket rebuilds
        # nothing.
        self._program_cache = {}
        self._amp_bucket = None  # no static data: nothing to bucket
        if uses_static_envelope(self.cp):
            self._amp_bucket = self._bucket_for(
                np.max(np.abs(self.cp.guess_pulsevals), axis=1)
            )
        self.fg, self.f = self._programs()

        continue_from = self.kwargs.get("continue_from", None)
        if continue_from is not None:
            import logging
            logging.getLogger(__name__).info(
                "Continuing previous optimization"
            )
            result = continue_from
            if not isinstance(result, GrapeResult):
                result = GrapeResult.from_result(
                    result, self.trajectories, tlist, self.kwargs
                )
            result.iter_stop = int(self.kwargs.get("iter_stop", 5000))
            result.converged = False
            import datetime
            import time
            result.start_local_time = datetime.datetime.now()
            result.clock_mark = time.perf_counter()
            result.message = "in progress"
            self.pulsevals = np.concatenate(
                [
                    discretize_on_midpoints(c, result.tlist)
                    for c in result.optimized_controls
                ]
            )
            self.result = result
        else:
            self.result = GrapeResult(self.trajectories, tlist, self.kwargs)
            self.pulsevals = self.cp.guess_pulsevals.reshape(-1).copy()

        self.pulsevals_guess = self.pulsevals.copy()
        self.gradient = np.zeros(self.n)
        self.grad_J_Tb = np.zeros(self.n)
        self.grad_J_a = np.zeros(self.n)
        self.J_parts = np.zeros(3)
        self.tau_vals = np.zeros(len(self.trajectories), dtype=np.complex128)
        self.states = None  # (K, d) final states of latest evaluation
        self.fg_count = np.zeros(2, dtype=np.int64)  # [fg_calls, f_calls]

        # optimizer-introspection state (filled by the backend)
        self.optimizer = self.kwargs.get("optimizer", None)
        self.optimizer_state = None
        self.alpha = 0.0            # last line-search step width
        self.searchdirection = np.zeros(self.n)
        self.gradient_guess = np.zeros(self.n)  # gradient at start of iter

    # -- amplitude-envelope bucketing --------------------------------------

    def _bucket_for(self, amps):
        """Per-control amplitude envelope.

        Controls with a finite box bound in the VICINITY of the current
        amplitudes (within 16× of the natural power-of-two bucket) use
        the bound itself: the L-BFGS-B iterates can never exceed it, and
        the envelope is exact.  Loose sanity bounds far above the real
        amplitudes are NOT used (they would over-size the squaring count);
        those controls grow power-of-two buckets like unbounded ones.
        Amplitudes beyond the bound (callback mutation) also fall back to
        the growing bucket — correctness never depends on the iterates
        respecting the bounds."""
        amps = np.maximum(np.asarray(amps, dtype=np.float64), 0.05)
        L, N_T = self.cp.n_controls, self.cp.n_timesteps
        cap = np.maximum(
            np.abs(self.upper_bounds.reshape(L, N_T)).max(axis=1),
            np.abs(self.lower_bounds.reshape(L, N_T)).max(axis=1),
        )  # (L,) per-control bound envelope; inf where unbounded
        grown = np.exp2(np.ceil(np.log2(2.0 * amps)))
        use_cap = (
            np.isfinite(cap) & (amps <= cap) & (cap <= 16.0 * grown)
        )
        self._bucket_capped = use_cap
        return tuple(np.where(use_cap, cap, grown))

    def _build_programs(self, key):
        """Build (fg, f) for an envelope bucket `key`; ``fg`` in
        ``eval_device_calls`` blocks where that is above 1."""
        amp_max = np.asarray(key) if key is not None else None
        if self.eval_device_calls > 1:
            fg = build_fg_multicall(self.cp, amp_max=amp_max,
                                    n_calls=self.eval_device_calls)
        else:
            fg = build_fg(self.cp, amp_max=amp_max)
        return fg, build_f(self.cp, amp_max=amp_max)

    def _programs(self):
        key = self._amp_bucket
        if key not in self._program_cache:
            with span("grape.build_programs"):
                self._program_cache[key] = self._build_programs(key)
        return self._program_cache[key]

    def _amplitudes(self, x):
        """Per-control maximum of ``|x|``."""
        N_T = self.cp.n_timesteps
        return np.max(np.abs(np.reshape(np.asarray(x), (-1, N_T))), axis=1)

    def _outside_envelope(self, x):
        """True if the pulse exceeds the envelope bucket."""
        if self._amp_bucket is None:
            return False
        return bool(np.any(self._amplitudes(x) > np.asarray(self._amp_bucket)))

    def _ensure_envelope(self, x):
        """Grow the envelope bucket if the pulse exceeds it."""
        with span("grape.envelope"):
            if self._outside_envelope(x):
                self._amp_bucket = self._bucket_for(np.maximum(
                    self._amplitudes(x), np.asarray(self._amp_bucket)))
                self.fg, self.f = self._programs()

    def _grow_envelope(self):
        """Double the envelope bucket: the Taylor safety net, where the
        series did not converge inside the envelope."""
        with span("grape.envelope"):
            self._amp_bucket = self._bucket_for(
                2.0 * np.asarray(self._amp_bucket))
            self.fg, self.f = self._programs()

    # -- device evaluation entry points ------------------------------------

    def _store_common(self, aux):
        self.J_parts[:] = _to_numpy(aux["J_parts"], np.float64)
        self.tau_vals[:] = _to_numpy(aux["tau"])
        self.states = _to_numpy(aux["psi_T"])

    def _dispatch_fw_prop_callback(self, aux):
        """The per-step observables callback: the evaluation forms the
        observables over the whole stored trajectory and the callback
        receives all per-step values once per evaluation:
        ``fw_prop_callback(values, tlist)`` with ``values`` a tuple of
        complex ``(N_T+1, ...)`` numpy arrays (the states themselves when no
        ``fw_prop_observables`` were given)."""
        if self.cp.fw_prop_callback is None:
            return
        values = tuple(_to_numpy(v) for v in aux["fw_observables"])
        self.cp.fw_prop_callback(values, self.tlist)

    # Each evaluation is the span ``grape.evaluate_*``: the envelope check,
    # ``grape.dispatch`` (the program's call, which enqueues the work on the
    # card and returns its results as device tensors) and ``grape.readback``
    # (everything after it: the first reads wait for the card).

    def evaluate_functional(self, x, count_call=True):
        with span("grape.evaluate_functional"):
            self._ensure_envelope(x)
            with span("grape.dispatch"):
                J, aux = self.f(np.asarray(x, dtype=np.float64))
            with span("grape.readback"):
                if count_call:
                    self.fg_count[1] += 1
                    self.result.f_calls += 1
                self._store_common(aux)
                self._dispatch_fw_prop_callback(aux)
                return float(J)

    def evaluate_gradient(self, x, G_out=None):
        with span("grape.evaluate_gradient"):
            self._ensure_envelope(x)
            with span("grape.dispatch"):
                J, G, aux = self.fg(np.asarray(x, dtype=np.float64))
            with span("grape.readback"):
                if not bool(aux["taylor_ok"]) and self._amp_bucket:
                    # safety net: the static Taylor order was sized from
                    # the amplitude envelope; if the honest last-term check
                    # still fails (envelope bound too loose for this
                    # problem), grow the bucket once (more orders) before
                    # giving up
                    self._grow_envelope()
                    with span("grape.dispatch"):
                        J, G, aux = self.fg(np.asarray(x, dtype=np.float64))
                self.fg_count[0] += 1
                self.result.fg_calls += 1
                self._store_common(aux)
                if not bool(aux["taylor_ok"]):
                    raise RuntimeError(
                        "Taylor gradient series did not converge within "
                        f"max_order={self.cp.taylor_grad_max_order} terms "
                        f"(tolerance={self.cp.taylor_grad_tolerance}); "
                        "decrease the time step or increase "
                        "taylor_grad_max_order"
                    )
                if not bool(aux["chi_ok"]):
                    raise RuntimeError(
                        f"The norm of a state χ(T) is below chi_min_norm="
                        f"{self.cp.chi_min_norm}: the gradient is zero"
                    )
                G = _to_numpy(G, np.float64)
                if G_out is not None:
                    G_out[:] = G
                self.gradient[:] = G
                self.grad_J_Tb[:] = _to_numpy(aux["grad_J_Tb"],
                                              np.float64)
                self.grad_J_a[:] = _to_numpy(aux["grad_J_a"], np.float64)
                self._dispatch_fw_prop_callback(aux)
                return float(J), G


# --------------------------------------------------------------------------
# Introspection helpers: callback-safe access to optimizer internals.
# --------------------------------------------------------------------------

def step_width(wrk):
    """Line-search step width α of the current iteration."""
    return float(wrk.alpha)


def search_direction(wrk):
    """Search direction used in the current iteration (falls back to ``-∇J``
    before the first iteration)."""
    s = np.asarray(wrk.searchdirection)
    if not np.any(s):
        return -np.asarray(wrk.gradient)
    return s


def norm_search(wrk):
    return float(np.linalg.norm(search_direction(wrk)))


def gradient(wrk, which="initial"):
    """Gradient associated with the current iteration.

    ``which="initial"``: gradient at the iterate from which the current
    iteration started (what determined the search direction);
    ``which="final"``: gradient at the optimized point of the iteration."""
    if which == "final":
        return np.asarray(wrk.gradient)
    g = np.asarray(wrk.gradient_guess)
    if not np.any(g):
        return np.asarray(wrk.gradient)
    return g


def pulse_update(wrk):
    """``pulsevals - pulsevals_guess`` for the current iteration."""
    return np.asarray(wrk.pulsevals) - np.asarray(wrk.pulsevals_guess)


def vec_angle(v1, v2, unit="rad"):
    """Angle between two vectors, numerically robust 2·atan form."""
    v1 = np.asarray(v1, dtype=np.float64)
    v2 = np.asarray(v2, dtype=np.float64)
    n1 = np.linalg.norm(v1)
    n2 = np.linalg.norm(v2)
    if n1 == 0 or n2 == 0:
        return 0.0
    u1 = v1 / n1
    u2 = v2 / n2
    angle = 2 * np.arctan2(
        np.linalg.norm(u1 - u2), np.linalg.norm(u1 + u2)
    )
    if unit == "degree":
        return float(np.degrees(angle))
    return float(angle)
