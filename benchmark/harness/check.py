"""Whether what the timed path produced is correct, each number within its
limit.  A cell compares the numbers that its ``workloads/<cell>.json``
gives limits for:

- ``J_T_gap``: the largest ``|J_T recorded by the solve - J_T of the
  reference|`` over the checked iterates of the window (the outer loop's
  record, which is the evaluation's value at the accepted iterate);
- ``grad_gap``: the largest ``max |g - g_ref| / max |g_ref|`` over the
  checked iterates (the evaluation layer's gradient);
- ``J_T_rise``: the largest rise of a solve's J_T from its guess to its
  last iterate (an L-BFGS-B iterate never raises J_T; limit 0);
- ``path_J_gap`` and ``path_x_gap``: the outer loop's path.  The window's
  first solve after ``path_iterations`` iterations against scipy's
  L-BFGS-B run from the same guess on the reference's ``value_and_grad``,
  with the program's settings (``m = 10``, ``factr = 1e1``, ``pgtol =
  1e-15``): the gap of J_T, and the largest gap of a pulse value over the
  largest distance that the reference's pulses travelled from the guess.
"""

import math

import numpy as np

__all__ = ["NUMBERS", "compare", "rise", "lbfgsb_path", "path_gaps",
           "passes"]

NUMBERS = ("J_T_gap", "grad_gap", "J_T_rise", "path_J_gap", "path_x_gap")

# the program's L-BFGS-B settings (grape_tpu_torch.optimizers.lbfgsb)
LBFGSB_M, LBFGSB_FACTR, LBFGSB_PGTOL = 10, 1e1, 1e-15


def compare(reference, records):
    """``J_T_gap`` and ``grad_gap`` of ``records`` (each with ``pulses``,
    ``J_T``, ``gradient``) against ``reference.value_and_grad``."""
    gaps = {"J_T_gap": 0.0, "grad_gap": 0.0}
    for rec in records:
        J_ref, g_ref = reference.value_and_grad(rec["pulses"])
        g = np.asarray(rec["gradient"], dtype=np.float64)
        J_gap = abs(rec["J_T"] - J_ref)
        scale = float(np.max(np.abs(g_ref)))
        g_gap = (float(np.max(np.abs(g - g_ref))) / scale if scale > 0
                 else math.inf)
        for key, val in (("J_T_gap", J_gap), ("grad_gap", g_gap)):
            gaps[key] = val if not math.isfinite(val) else max(gaps[key], val)
    return gaps


def rise(solves):
    """The largest ``J_T(last iterate) - J_T(guess)`` over ``solves``
    (each with ``J_T`` and ``J_T_guess``); infinite where a solve recorded
    no guess."""
    worst = 0.0
    for s in solves:
        if s.get("J_T_guess") is None:
            return math.inf
        worst = max(worst, s["J_T"] - s["J_T_guess"])
    return worst


def lbfgsb_path(value_and_grad, guess, bounds, iterations):
    """``(J_T, pulses)`` after ``iterations`` iterations of scipy's L-BFGS-B
    from ``guess`` on ``value_and_grad`` (bounds ``+-bounds`` on every
    value, or none); J_T is NaN where it stopped before them."""
    from scipy.optimize import minimize

    x0 = np.asarray(guess, dtype=np.float64)
    box = (None if bounds is None
           else [(-float(bounds), float(bounds))] * x0.size)
    res = minimize(
        lambda x: value_and_grad(x.reshape(x0.shape)), x0.reshape(-1),
        jac=True, method="L-BFGS-B", bounds=box,
        options={"maxcor": LBFGSB_M, "maxiter": int(iterations),
                 "ftol": LBFGSB_FACTR * np.finfo(float).eps,
                 "gtol": LBFGSB_PGTOL})
    J = float(res.fun) if int(res.nit) == int(iterations) else math.nan
    return J, res.x.reshape(x0.shape)


def path_gaps(ref_path, path, guess):
    """``path_J_gap`` and ``path_x_gap`` of ``path = (J_T, pulses)``
    against the reference's ``ref_path``; infinite where the window's
    first solve made no iteration to follow (``None``)."""
    if path is None or ref_path is None:
        return {"path_J_gap": math.inf, "path_x_gap": math.inf}
    J_ref, x_ref = ref_path
    J, x = path
    travel = float(np.max(np.abs(x_ref - np.asarray(guess))))
    x_gap = (float(np.max(np.abs(np.asarray(x) - x_ref))) / travel
             if travel > 0 else math.inf)
    if not (math.isfinite(J) and math.isfinite(J_ref)):
        return {"path_J_gap": math.inf, "path_x_gap": math.inf}
    return {"path_J_gap": abs(J - J_ref), "path_x_gap": x_gap}


def passes(numbers, limits):
    """True where every limited number is finite and within its limit."""
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k]
               for k in limits)
