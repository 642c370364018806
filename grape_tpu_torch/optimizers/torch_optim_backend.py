"""``torch.optim`` optimizer backend.

Counterpart of ``grape_tpu/optimizers/optax_backend.py``: drive the GRAPE fg
evaluations with a ``torch.optim.Optimizer`` — Adam, SGD with momentum,
LBFGS, ... — given as the class or as a ``functools.partial`` of it with
keyword arguments, e.g. ``optimize(..., optimizer=functools.partial(
torch.optim.Adam, lr=0.05))``.  The optimizer is built over one float64
leaf tensor holding the pulse vector, on the problem's device.  Box bounds
are honored by projection after each step (torch.optim has no bound
support, as optax has none).

Each iteration sets the leaf's ``.grad`` to the gradient of the last
evaluation, calls ``step()``, projects, and evaluates at the new pulse.
An optimizer whose ``step`` takes a closure (``torch.optim.LBFGS``) gets
one that evaluates ``fg`` at the leaf's value through the workspace, so
every line-search probe is counted in ``wrk.fg_count`` and
``result.fg_calls``; at the iterate the driver has just evaluated it hands
back that evaluation instead of repeating it.  ``torch.optim.LBFGS`` runs
up to ``max_iter`` inner iterations in one ``step()`` while GRAPE counts
one iteration per ``step()``, so it is built with ``max_iter=1`` unless the
partial gives one (and with a line-search budget of 25 evaluations,
:func:`build_torch_optimizer`).

SGD with momentum and Adam follow the same update rules as their optax
counterparts.  ``torch.optim.LBFGS`` is not ``optax.lbfgs`` (its optional
line search is a strong-Wolfe search by cubic interpolation, optax's a zoom
search): a deviation from the reference, whose introspection and counting
invariants it keeps.
"""

import functools
import warnings

import numpy as np
import torch

__all__ = ["TorchOptimBackend", "is_torch_optimizer", "build_torch_optimizer"]


def _optimizer_class(factory):
    return factory.func if isinstance(factory, functools.partial) else factory


def is_torch_optimizer(factory):
    """True for a ``torch.optim.Optimizer`` subclass or a
    ``functools.partial`` of one."""
    cls = _optimizer_class(factory)
    return isinstance(cls, type) and issubclass(cls, torch.optim.Optimizer)


def build_torch_optimizer(factory, param):
    """The optimizer over ``[param]``.  ``torch.optim.LBFGS`` gets
    ``max_iter=1`` unless the partial gives ``max_iter``, and then
    ``max_eval=25`` unless it gives ``max_eval``: torch derives the line
    search's budget from ``max_eval`` (by default ``1.25·max_iter``, which
    at one iteration would allow one trial), and 25 is its budget at its
    default ``max_iter=20``."""
    extra = {}
    keywords = getattr(factory, "keywords", {}) or {}
    if issubclass(_optimizer_class(factory), torch.optim.LBFGS) and (
            "max_iter" not in keywords):
        extra["max_iter"] = 1
        if "max_eval" not in keywords:
            extra["max_eval"] = 25
    return factory([param], **extra)


def has_line_search(opt):
    """Only line-search optimizers promise descent."""
    return isinstance(opt, torch.optim.LBFGS) and (
        opt.defaults.get("line_search_fn") is not None)


def step_introspection(opt, param, step):
    """``(α, s)`` with ``Δu = α·s``: for ``torch.optim.LBFGS`` its step
    width ``state["t"]`` and direction ``state["d"]``; otherwise the update
    IS the step taken, ``α = 1`` and ``s = Δu``."""
    if isinstance(opt, torch.optim.LBFGS):
        state = opt.state[param]
        t = state.get("t")
        if t is not None and state.get("d") is not None:
            alpha = float(t)
            if np.isfinite(alpha) and alpha > 0.0:
                return alpha, state["d"]
    return 1.0, step


class TorchOptimBackend:
    def __init__(self, factory, project_bounds=True):
        if not is_torch_optimizer(factory):
            raise TypeError(
                f"{factory!r} is not a torch.optim.Optimizer subclass or a "
                "functools.partial of one"
            )
        self.factory = factory
        self.project_bounds = project_bounds

    def run(self, wrk, fg, callback, check_convergence):
        from ..optimize import apply_convergence_check, update_result

        x = np.asarray(wrk.pulsevals, dtype=np.float64)
        wrk.pulsevals = x
        dev = wrk.cp.device
        param = torch.tensor(x, dtype=torch.float64, device=dev,
                             requires_grad=True)
        opt = build_torch_optimizer(self.factory, param)
        g = np.zeros_like(x)
        lo = torch.as_tensor(wrk.lower_bounds, dtype=torch.float64,
                             device=dev)
        hi = torch.as_tensor(wrk.upper_bounds, dtype=torch.float64,
                             device=dev)

        def set_grad(grad):
            param.grad = torch.as_tensor(grad, dtype=torch.float64,
                                         device=dev).clone()

        def closure():
            # a line-search probe at the leaf's value: counted through the
            # workspace (fg_count[0], result.fg_calls), unless it is the
            # iterate the driver evaluated last
            xp = param.detach().cpu().numpy()
            if np.array_equal(xp, x):
                set_grad(g)
                return float(f)
            gp = np.zeros_like(xp)
            fp = fg(0.0, gp, xp)
            set_grad(gp)
            return fp

        # iteration 0
        f = fg(0.0, g, x)
        wrk.gradient_guess[:] = g
        update_result(wrk, 0)
        rec = callback(wrk, 0)
        wrk.fg_count[:] = 0
        if rec:
            wrk.result.records.append(rec)

        has_bounds = np.any(np.isfinite(wrk.lower_bounds)) or np.any(
            np.isfinite(wrk.upper_bounds)
        )
        line_search = has_line_search(opt)
        allow_f_inc = bool(wrk.kwargs.get("allow_f_increases", False))
        warned_inc = False
        warned_stall = False
        while True:
            with torch.no_grad():
                param.copy_(torch.from_numpy(x))  # honors pulse mutation
            set_grad(g)
            opt.step(closure)
            with torch.no_grad():
                if has_bounds and self.project_bounds:
                    param.copy_(torch.minimum(torch.maximum(param, lo), hi))
                x_new = param.detach().cpu().numpy().copy()
            step = x_new - x
            alpha, s = step_introspection(opt, param, step)
            wrk.alpha = alpha
            wrk.searchdirection[:] = (
                s.detach().cpu().numpy() if torch.is_tensor(s) else s
            )
            if not np.any(step) and not warned_stall:
                warnings.warn(
                    "torch.optim update is identically zero (line search "
                    "stalled): the optimizer cannot make progress — "
                    f"‖∇J‖ = {float(np.linalg.norm(g)):.3e}"
                )
                warned_stall = True
            x[:] = x_new
            f_prev = float(f)
            f = fg(0.0, g, x)
            # only line-search optimizers promise descent (a fixed
            # learning rate legitimately overshoots)
            if (line_search and f > f_prev and not allow_f_inc
                    and not warned_inc):
                warnings.warn(
                    f"objective increased ({f_prev:.6e} -> {float(f):.6e});"
                    " the accepted step was not a descent step (pass "
                    "allow_f_increases=True to silence)"
                )
                warned_inc = True
            it = wrk.result.iter + 1
            update_result(wrk, it)
            rec = callback(wrk, wrk.result.iter)
            wrk.fg_count[:] = 0
            if rec:
                wrk.result.records.append(rec)
            apply_convergence_check(wrk.result, check_convergence)
            if wrk.result.converged:
                break
            wrk.pulsevals_guess[:] = x
            wrk.gradient_guess[:] = g
        return None
