"""GRAPE optimization front end.

Counterpart of ``grape_tpu/optimize.py``: entry points, the ``fg`` closure
over the workspace, the optimizer backend, the convergence-check protocol,
per-iteration result updates, and result finalization.  The host-side
L-BFGS-B consumes function/gradient values from the device evaluation.
"""

import contextlib
import datetime
import time
import traceback

import numpy as np
import torch

from .controls import discretize
from .tracing import own_profiler, span
from .workspace import GrapeWrk

__all__ = ["optimize", "optimize_problem", "run_optimizer"]


def optimize_problem(problem, method="grape", **updates):
    """Optimize a :class:`~grape_tpu_torch.trajectory.ControlProblem`
    (``QuantumControl.optimize(problem; method=GRAPE)`` analog);
    ``method="krotov"`` dispatches to
    :func:`grape_tpu_torch.optimize_krotov`."""
    kwargs = dict(problem.kwargs)
    kwargs.update(updates)
    method_l = str(method).lower()
    if method_l == "krotov":
        from .krotov import optimize_krotov

        return optimize_krotov(problem.trajectories, problem.tlist,
                               **kwargs)
    if method_l != "grape":
        raise ValueError(
            f"Unknown optimization method {method!r} "
            "(supported: 'grape', 'krotov')"
        )
    return optimize(problem.trajectories, problem.tlist, **kwargs)


def optimize(trajectories, tlist, **kwargs):
    """Run a GRAPE optimization; returns a :class:`GrapeResult`.

    Keyword arguments: required ``J_T``; optional ``chi``, ``chi_min_norm``,
    ``J_a``, ``grad_J_a``, ``lambda_a``, ``g_b``, ``xi``, ``lambda_b``
    (the state running cost and its co-state source),
    ``gradient_method`` (``"gradgen"``,
    ``"taylor"`` or ``"auto"``), ``taylor_grad_max_order``,
    ``taylor_grad_tolerance``, ``taylor_grad_check_convergence``,
    ``reuse_propagators``, ``vectorize_backward``, ``prop_method`` and
    ``fw_/bw_/grad_prop_method`` (``"expprop"``, ``"cheby"``,
    ``"newton"``), ``cheby_tol``, ``newton_m``, ``newton_substeps``,
    ``storage_mode`` (``"full"`` or ``"recompute"``) and
    ``storage_segments``, ``fw_prop_callback`` (with optional
    ``fw_prop_observables``, functions ``(Psi, tlist, n) -> array``; the
    callback receives ``(values, tlist)`` after every evaluation, full
    storage only), ``dtype``, ``upper_bound``/``lower_bound``/``pulse_options``,
    ``callback``, ``check_convergence``, ``iter_start``/``iter_stop``,
    ``continue_from``, ``verbose``, ``rethrow_exceptions``,
    ``print_iters``/``print_iter_info``/``store_iter_info``, optimizer
    tuning (``lbfgsb_m``, ``lbfgsb_factr``, ``lbfgsb_pgtol``,
    ``lbfgsb_iprint``) and ``device``.

    ``atexit_filename`` registers a crash dump for the run: should the
    process exit while the optimization is in flight, the in-progress
    result is saved there (``io.save_result``, tagged ``interrupted`` and
    with ``atexit_config_digest``), and ``io.optimize_or_load`` resumes
    from it.  ``profile_dir`` traces the whole call with ``torch.profiler``
    (the host, and the card when the problem runs on CUDA) and writes a
    Chrome trace into that directory, with the port's ``grape.*`` spans
    (``tracing``) beside the kernels: the solve, its set-up, each L-BFGS-B
    step, each evaluation and its stages.

    Trajectories may carry their own ``prop_method`` (and
    ``fw_/bw_/grad_prop_method``): an ensemble whose members differ is
    partitioned into uniform problems (``fg_hetero``), with the functional
    and the gradient assembled over all of them.  ``continue_from`` takes a
    :class:`GrapeResult`, a :class:`~grape_tpu_torch.krotov.KrotovResult`
    or a reloaded one, with continuous iteration numbers.

    ``device=None`` means the CUDA device and raises if there is none;
    pass ``device="cpu"`` to run the plain PyTorch versions on the CPU.
    ``optimizer=`` picks the backend (:func:`_get_optimizer`), with its
    options ``device_loop_iters``, ``f_tol``, ``g_tol``, ``x_tol``,
    ``show_trace``, ``scipy_options`` and ``allow_f_increases``.
    ``mesh=`` (``parallel.make_mesh()`` in a process group of
    ``parallel.init_distributed``, e.g. under ``torchrun``) shards the
    trajectories over the ranks: each rank evaluates its block and the
    loop runs on every rank in lockstep on the reduced ``(J, grad)``.
    ``eval_device_calls=n`` (recompute storage and a segment-vectorized
    backward pass, else ``ValueError``) evaluates through
    ``fg.build_fg_multicall``, the backward pass in ``n`` blocks with the
    same arithmetic; ``use_pallas`` and ``gradgen_pallas_precision`` go to
    :func:`~grape_tpu_torch.fg.compile_problem`;
    ``max_embedded_constant_bytes`` and ``prewarm_envelope`` have no effect
    (``workspace``).
    """
    if "update_hook" in kwargs or "info_hook" in kwargs:
        raise ValueError(
            "The `update_hook` and `info_hook` arguments have been "
            "superseded by the `callback` argument"
        )
    with _profiled(kwargs.get("profile_dir", None),
                   kwargs.get("device", None)), span("grape.solve",
                                                     hooks=True):
        with span("grape.setup"):
            callback = _wrap_callback(kwargs)
            check_convergence = kwargs.get("check_convergence",
                                           lambda res: res)

            if kwargs.get("check", True):
                from .interfaces import check_problem

                check_problem(trajectories, tlist)

            wrk = GrapeWrk(trajectories, tlist, kwargs)

            if wrk.cp.J_a is None and "grad_J_a" in kwargs:
                import warnings
                warnings.warn(
                    "Argument `grad_J_a` was given without `J_a`. Ignoring")

            def fg(F, G, x):
                """Reference ``fg!`` closure."""
                if G is None:
                    return wrk.evaluate_functional(x)
                J, _ = wrk.evaluate_gradient(x, G_out=G)
                return J

            optimizer = _get_optimizer(wrk)
            atexit_filename = kwargs.get("atexit_filename", None)
            atexit_hook = None
            if atexit_filename is not None:
                import atexit
                from .io import save_result

                def _crash_save():
                    # crash dump: tagged `interrupted` (+ the producing
                    # config's digest when known) so optimize_or_load
                    # resumes or re-runs instead of returning the partial
                    # result as final
                    save_result(
                        wrk.result, atexit_filename,
                        config_digest=kwargs.get("atexit_config_digest",
                                                 None),
                        interrupted=True,
                    )

                atexit.register(_crash_save)
                atexit_hook = _crash_save

        try:
            run_optimizer(optimizer, wrk, fg, callback, check_convergence)
        except KeyboardInterrupt:
            wrk.result.message = "Exception: InterruptException"
        except Exception as exc:
            if kwargs.get("rethrow_exceptions", False):
                raise
            wrk.result.message = f"Exception: {exc}"
            if kwargs.get("verbose", False):
                traceback.print_exc()

        finalize_result(wrk)
        if atexit_hook is not None:
            import atexit
            atexit.unregister(atexit_hook)
    return wrk.result


@contextlib.contextmanager
def _profiled(profile_dir, device):
    """A ``torch.profiler.profile`` context around the whole optimization
    (set-up, loop and finalization) when ``profile_dir`` is given (host
    activity, and the card's where ``device`` is a CUDA one, as ``None``
    is), else a context that does nothing.  On exit it writes one Chrome
    trace (``<host>_<pid>.<ns>.pt.trace.json``) into ``profile_dir``."""
    if profile_dir is None:
        yield
        return
    from torch import profiler

    activities = [profiler.ProfilerActivity.CPU]
    if (torch.device("cuda" if device is None else device).type == "cuda"
            and torch.cuda.is_available()):
        activities.append(profiler.ProfilerActivity.CUDA)
    with profiler.profile(
        activities=activities,
        on_trace_ready=profiler.tensorboard_trace_handler(str(profile_dir)),
    ), own_profiler():
        yield


def _wrap_callback(kwargs):
    """Combine user callback(s) and iteration printing into one callable."""
    from .info_table import make_grape_print_iters

    cbs = []
    user_cb = kwargs.get("callback", None)
    if user_cb is not None:
        if isinstance(user_cb, (tuple, list)):
            cbs.extend(user_cb)
        else:
            cbs.append(user_cb)
    print_iters = kwargs.get("print_iters", True)
    print_iter_info = kwargs.get("print_iter_info", None)
    store_iter_info = kwargs.get("store_iter_info", None)
    if print_iters or store_iter_info is not None:
        cbs.append(
            make_grape_print_iters(
                print_iter_info=print_iter_info,
                store_iter_info=store_iter_info,
                print_iters=print_iters,
                g_b=kwargs.get("g_b", None),
            )
        )

    def combined(wrk, iteration):
        records = ()
        for cb in cbs:
            res = cb(wrk, iteration)
            if res is not None and res != ():
                if not isinstance(res, tuple):
                    res = (res,)
                records = records + res
        return records if records else None

    return combined


def _get_optimizer(wrk):
    """The optimizer backend named by ``optimizer=``.

    - ``"lbfgsb"``: the native C++ L-BFGS-B reverse-communication backend
      (exact reference semantics).  Where it cannot be built and was not
      asked for by name, the scipy backend takes its place.
    - ``"scipy-lbfgsb"``: ``scipy.optimize.minimize(method="L-BFGS-B")``
      (``optimizers/scipy_backend.py``; options ``f_tol``, ``g_tol``,
      ``x_tol``, ``show_trace``, ``scipy_options``).
    - ``"device-lbfgs"``: the device-resident chunked L-BFGS loop
      (``optimizers/device_loop.py``), ``device_loop_iters`` (default 10)
      iterations a chunk.
    - a ``torch.optim.Optimizer`` subclass or a ``functools.partial`` of
      one (``optimizers/torch_optim_backend.py``; the counterpart of the
      reference's optax transformations).
    - any other object with ``.run()``: a user's backend, passed through.
    - ``"auto"`` (the default): the native L-BFGS-B on every device.  The
      reference takes the device loop on its TPU, where every host round
      trip is dear.  On the H100 the device loop is no faster than the
      host loop at the same squaring count on any cell measured (the CZ,
      the 8 × 4 ensemble, the 1024 qutrits; ``PERF.md``): its
      L-BFGS step is several hundred small tensor operations an
      iteration, each dispatched from Python, which cost as much as the
      host loop's copies or more.  So ``"auto"`` takes the host loop
      whenever ``eval_device_calls > 1`` too, as the reference does.
    """
    opt = wrk.kwargs.get("optimizer", None)
    name = opt if isinstance(opt, str) else None
    if opt is None or name in ("auto", "lbfgsb"):
        try:
            from .optimizers.lbfgsb import LBFGSB

            return LBFGSB(
                m=int(wrk.kwargs.get("lbfgsb_m", 10)),
                factr=float(wrk.kwargs.get("lbfgsb_factr", 1e1)),
                pgtol=float(wrk.kwargs.get("lbfgsb_pgtol", 1e-15)),
                iprint=int(wrk.kwargs.get("lbfgsb_iprint", -1)),
            )
        except Exception:
            if name == "lbfgsb":  # asked for by name: no stand-in
                raise
            from .optimizers.scipy_backend import ScipyLBFGSB

            return ScipyLBFGSB(wrk.kwargs)
    if name == "scipy-lbfgsb":
        from .optimizers.scipy_backend import ScipyLBFGSB

        return ScipyLBFGSB(wrk.kwargs)
    if name == "device-lbfgs":
        from .optimizers.device_loop import DeviceLoopBackend

        return DeviceLoopBackend(
            chunk_iters=int(wrk.kwargs.get("device_loop_iters", 10)),
        )
    from .optimizers.torch_optim_backend import (
        TorchOptimBackend, is_torch_optimizer,
    )

    if is_torch_optimizer(opt):
        return TorchOptimBackend(opt)
    return opt  # a user's backend object with .run()


def run_optimizer(optimizer, wrk, fg, callback, check_convergence):
    """Dispatch to the optimizer backend."""
    if hasattr(optimizer, "run"):
        return optimizer.run(wrk, fg, callback, check_convergence)
    raise ValueError(f"Unknown optimizer: {optimizer!r}")


def apply_convergence_check(result, check_convergence):
    """Convergence-check protocol: the check may return a bool, a reason
    string (empty = not converged), ``None``, or the (possibly mutated)
    result object."""
    if result.converged:
        return
    converged = check_convergence(result)
    if isinstance(converged, (bool, np.bool_)):
        result.converged = bool(converged)
        if converged:
            result.message = "Convergence check returned true"
    elif isinstance(converged, str):
        if converged:
            result.converged = True
            result.message = converged
    elif converged is None or converged is result:
        pass
    else:
        import warnings
        warnings.warn(
            "The check_convergence function did not return a Boolean, "
            "String, None, or modified GrapeResult object"
        )


def update_result(wrk, i):
    """Per-iteration result update.  ``secs`` is the time since the
    previous update (or since the result was made), on the monotonic
    ``time.perf_counter`` clock."""
    with span("grape.update_result"):
        res = wrk.result
        if wrk.states is not None:
            res.states = [np.asarray(s) for s in wrk.states]
        res.tau_vals = np.asarray(wrk.tau_vals).copy()
        res.J_T_prev = res.J_T
        res.J_T = wrk.J_parts[0]
        res.J_a_prev = res.J_a
        res.J_a = wrk.J_parts[1]
        if res.J_a > 0.0:
            lambda_a = wrk.kwargs.get("lambda_a", 1.0)
            res.J_a /= lambda_a
        res.J_b_prev = res.J_b
        lambda_b = wrk.kwargs.get("lambda_b", 1.0)
        g_b = wrk.kwargs.get("g_b", None)
        if not (lambda_b == 0 and g_b is None):
            res.J_b = wrk.J_parts[2] / lambda_b if lambda_b != 0 else 0.0
        else:
            res.J_b = 0.0
        if i > 0:
            res.iter = i
        if i >= res.iter_stop:
            res.converged = True
            res.message = "Reached maximum number of iterations"
        now = time.perf_counter()
        res.secs = now - res.clock_mark
        res.clock_mark = now
        res.end_local_time = datetime.datetime.now()


def finalize_result(wrk):
    """Discretize final midpoint pulses back onto the time-grid points."""
    with span("grape.finalize"):
        res = wrk.result
        res.end_local_time = datetime.datetime.now()
        N_T = len(res.tlist) - 1
        res.optimized_controls = [
            discretize(wrk.pulsevals[l * N_T:(l + 1) * N_T], res.tlist)
            for l in range(len(wrk.controls))
        ]
