"""Scipy L-BFGS-B backend (``optimizer="scipy-lbfgsb"``).

Counterpart of ``grape_tpu/optimizers/scipy_backend.py``: adapts
``scipy.optimize.minimize(method="L-BFGS-B")`` to the GRAPE driver protocol.
Unlike the native reverse-communication backend
(:mod:`grape_tpu_torch.optimizers.lbfgsb`), scipy owns the iterate, so a
callback's pulse mutation is not honored.  Every evaluation goes through the
workspace's ``fg`` closure, so the problem runs on its own device (the card
unless ``device="cpu"``); scipy sees float64 numpy arrays.
"""

import warnings

import numpy as np
from scipy.optimize import minimize

from ..optimize import apply_convergence_check, update_result

__all__ = ["ScipyLBFGSB"]


class _Stop(Exception):
    pass


class ScipyLBFGSB:
    """Options: ``lbfgsb_m``, ``lbfgsb_factr``, ``lbfgsb_pgtol`` (the native
    backend's defaults), ``f_tol`` (scipy's relative ``ftol``), ``g_tol``
    (the projected-gradient ``gtol``), ``show_trace`` (``iprint=100``) and a
    raw ``scipy_options`` dict merged last.  ``x_tol`` has no scipy
    counterpart: it warns and is ignored."""

    def __init__(self, kwargs):
        self.m = int(kwargs.get("lbfgsb_m", 10))
        self.factr = float(kwargs.get("lbfgsb_factr", 1e1))
        self.pgtol = float(kwargs.get("lbfgsb_pgtol", 1e-15))
        self.f_tol = kwargs.get("f_tol")
        self.g_tol = kwargs.get("g_tol")
        self.show_trace = bool(kwargs.get("show_trace", False))
        self.scipy_options = dict(kwargs.get("scipy_options", {}))
        if kwargs.get("x_tol") is not None:
            warnings.warn(
                "x_tol has no scipy L-BFGS-B analog; ignoring "
                "(use f_tol/g_tol or scipy_options)"
            )

    def run(self, wrk, fg, callback, check_convergence):
        x0 = np.asarray(wrk.pulsevals, dtype=np.float64).copy()
        bounds = None
        if np.any(np.isfinite(wrk.lower_bounds)) or np.any(
            np.isfinite(wrk.upper_bounds)
        ):
            bounds = list(zip(wrk.lower_bounds, wrk.upper_bounds))

        def jac_fun(x):
            G = np.zeros_like(x)
            J = fg(0.0, G, x)
            return J, G

        # iteration 0 (FG_START analog)
        _, g0 = jac_fun(x0)
        wrk.gradient_guess[:] = g0
        update_result(wrk, 0)
        rec = callback(wrk, 0)
        wrk.fg_count[:] = 0
        if rec:
            wrk.result.records.append(rec)

        def scipy_cb(xk):
            wrk.pulsevals[:] = xk
            it = wrk.result.iter + 1
            update_result(wrk, it)
            rec = callback(wrk, wrk.result.iter)
            wrk.fg_count[:] = 0
            if rec:
                wrk.result.records.append(rec)
            apply_convergence_check(wrk.result, check_convergence)
            if wrk.result.converged:
                raise _Stop
            wrk.pulsevals_guess[:] = xk
            wrk.gradient_guess[:] = wrk.gradient

        eps = np.finfo(np.float64).eps
        options = {
            "maxiter": max(wrk.result.iter_stop, 1),
            "maxcor": self.m,
            "ftol": (
                self.f_tol if self.f_tol is not None else self.factr * eps
            ),
            "gtol": self.g_tol if self.g_tol is not None else self.pgtol,
            "maxfun": 10**9,
        }
        if self.show_trace:
            options["iprint"] = 100
        options.update(self.scipy_options)
        try:
            res = minimize(
                jac_fun,
                x0,
                jac=True,
                method="L-BFGS-B",
                bounds=bounds,
                callback=scipy_cb,
                options=options,
            )
            wrk.pulsevals[:] = res.x
            if wrk.result.message == "in progress":
                wrk.result.message = str(res.message)
            self._postmortem(res, wrk)
        except _Stop:
            pass
        return None

    @staticmethod
    def _postmortem(res, wrk):
        """An abnormal termination (the line search found no acceptable
        point) gets an actionable warning beside the result message."""
        msg = str(res.message)
        if "ABNORM" in msg.upper() or "ERROR" in msg.upper():
            gnorm = float(np.linalg.norm(np.asarray(wrk.gradient)))
            warnings.warn(
                f"L-BFGS-B terminated abnormally: {msg} "
                f"(J = {float(res.fun):.3e}, ‖∇J‖ = {gnorm:.3e}). "
                "The line search could not find an acceptable point — "
                "consider loosening lbfgsb_factr/lbfgsb_pgtol, tighter "
                "pulse bounds, or rescaling the controls."
            )
