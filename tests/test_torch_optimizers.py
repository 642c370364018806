"""The optimizer backends of ``grape_tpu_torch`` against ``grape_tpu``.

The cases of the reference's ``tests/test_optax_backend.py`` and
``tests/test_jax_lbfgs.py`` on the port, in complex128 on the CPU:

- ``torch.optim`` SGD with momentum (and box bounds) and Adam against
  optax's ``sgd``/``adam``, which have the same update rules: the J_T series
  within 1e-9 of each value, the final pulses within 1e-9;
- ``torch.optim.LBFGS`` (not ``optax.lbfgs``: another line search, a stated
  deviation) held to the reference tests' invariants: Δu = α·s, line-search
  probes counted;
- ``torch_lbfgs`` against ``jax_lbfgs``: the two-loop direction within
  1e-12, the Moré–Thuente step and evaluation count equal; the Rosenbrock
  and bound cases on the port alone, against scipy (the reference's traced
  loops take tens of seconds to compile);
- ``optimizer="scipy-lbfgsb"`` against the reference's: the J_T series
  within 1e-10 of its scale (its first value: ``J_T = 1 - |τ|²`` cancels,
  so values near convergence carry rounding of 1e-16 absolute), the same
  iteration count and message, with and without its options;
- a user's backend object with ``.run()``, and the fallback from the native
  L-BFGS-B to scipy where it cannot be built.

Each reference optimization runs once (module fixtures).
"""

import functools

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import grape_tpu
from grape_tpu.optimizers import jax_lbfgs as ref_lbfgs

import grape_tpu_torch as gt
from grape_tpu_torch.controls import discretize_on_midpoints
from grape_tpu_torch.optimizers import torch_lbfgs
from grape_tpu_torch.workspace import norm_search, pulse_update, step_width

torch.set_num_threads(1)

SZ = np.array([[1, 0], [0, -1]], dtype=complex)
SX = np.array([[0, 1], [1, 0]], dtype=complex)


def guess_eps(t):
    return 0.2 * float(gt.shapes.flattop(t, T=5, t_rise=0.3,
                                         func="blackman"))


def _tls(pkg, n_points=201):
    H = pkg.hamiltonian(-0.5 * SZ, (SX, guess_eps))
    return ([pkg.Trajectory([1, 0], H, target_state=[0, 1])],
            np.linspace(0, 5, n_points))


def _run(pkg, **kw):
    """``optimize`` of ``pkg`` on the reference tests' TLS: ``(result, J_T
    series, callback records)``."""
    trajs, tlist = _tls(pkg)
    series, counts = [], []

    def cb(wrk, iteration):
        series.append(float(wrk.result.J_T))
        counts.append((int(wrk.fg_count[0]), int(wrk.fg_count[1])))

    user_cb = kw.pop("callback", None)
    extra = {"device": "cpu"} if pkg is gt else {}
    res = pkg.optimize(trajs, tlist, J_T=pkg.functionals.J_T_sm,
                       print_iters=False, rethrow_exceptions=True,
                       callback=[cb] + ([user_cb] if user_cb else []),
                       **extra, **kw)
    return res, np.asarray(series), counts


def _pulse(res):
    return discretize_on_midpoints(res.optimized_controls[0], res.tlist)


SGD = dict(iter_stop=50, lower_bound=-0.5, upper_bound=0.5)
ADAM = dict(iter_stop=60)


@pytest.fixture(scope="module")
def ref_sgd():
    return _run(grape_tpu, optimizer=optax.sgd(learning_rate=2.0,
                                               momentum=0.9), **SGD)


@pytest.fixture(scope="module")
def ref_adam():
    return _run(grape_tpu, optimizer=optax.adam(learning_rate=0.05), **ADAM)


def test_sgd_momentum_with_bounds_matches_optax(ref_sgd):
    res, series, _ = _run(gt, optimizer=functools.partial(
        torch.optim.SGD, lr=2.0, momentum=0.9), **SGD)
    ref, ref_series, _ = ref_sgd
    assert len(series) == len(ref_series) == 51
    np.testing.assert_allclose(series, ref_series, rtol=1e-9, atol=0)
    np.testing.assert_allclose(_pulse(res), _pulse(ref), rtol=0, atol=1e-9)
    assert np.max(np.abs(_pulse(res))) <= 0.5 + 1e-12  # projected
    assert res.J_T < 0.5


def test_adam_matches_optax(ref_adam):
    res, series, _ = _run(gt, optimizer=functools.partial(
        torch.optim.Adam, lr=0.05), **ADAM)
    ref, ref_series, _ = ref_adam
    assert len(series) == len(ref_series) == 61
    np.testing.assert_allclose(series, ref_series, rtol=1e-9, atol=0)
    np.testing.assert_allclose(_pulse(res), _pulse(ref), rtol=0, atol=1e-9)
    assert res.J_T < 0.3  # steady (non-monotonic) progress


def test_optimizer_class_without_partial():
    res, series, counts = _run(gt, optimizer=torch.optim.Adam, iter_stop=3)
    assert res.iter == 3 and series[-1] < series[0]
    assert counts[1:] == [(1, 0)] * 3  # one driver evaluation an iteration


def test_lbfgs_introspection_and_probe_counts():
    """``torch.optim.LBFGS`` with its strong-Wolfe line search: α is the
    search's step width and ``Δu = α·s``; every probe is counted, so the
    evaluations exceed one an iteration and the result's totals hold
    them; the step that stalls once the gradient is below torch's
    tolerance warns."""
    seen = []

    def cb(wrk, iteration):
        if iteration > 0:
            seen.append((step_width(wrk), norm_search(wrk),
                         np.linalg.norm(pulse_update(wrk))))

    with pytest.warns(UserWarning, match="identically zero"):
        res, series, counts = _run(
            gt, iter_stop=8, callback=cb,
            optimizer=functools.partial(torch.optim.LBFGS,
                                        line_search_fn="strong_wolfe"))
    moved = 0
    for alpha, ns, nu in seen:
        assert np.isfinite(alpha) and alpha > 0
        if nu == 0.0:
            continue  # the stalled step: no update
        moved += 1
        assert abs(nu - alpha * ns) <= 1e-9 * max(1.0, nu)
    assert moved >= 4
    assert res.J_T < 1e-8
    probe_evals = sum(f + fg for (fg, f) in counts[1:])
    driver_evals = len(counts) - 1
    assert probe_evals > driver_evals, counts
    assert res.f_calls + res.fg_calls >= probe_evals


def test_lbfgs_without_line_search_is_one_evaluation_an_iteration():
    res, series, counts = _run(
        gt, iter_stop=4, optimizer=functools.partial(torch.optim.LBFGS,
                                                     lr=0.5))
    assert counts[1:] == [(1, 0)] * 4
    assert res.iter == 4 and series[-1] < series[0]


# --------------------------------------------------------------------------
# torch_lbfgs against jax_lbfgs
# --------------------------------------------------------------------------

def _history(rng, n, m, n_pairs):
    S, Y, rho = np.zeros((m, n)), np.zeros((m, n)), np.zeros(m)
    for i in range(n_pairs):
        s = rng.normal(size=n)
        y = s + 0.3 * rng.normal(size=n)
        if np.dot(y, s) < 0:
            y = -y
        S[i % m], Y[i % m], rho[i % m] = s, y, 1.0 / np.dot(y, s)
    return S, Y, rho


@pytest.mark.parametrize("n_pairs", [0, 1, 3, 4, 7])
def test_two_loop_direction_matches_the_reference(n_pairs):
    """The direction of the same (circular, possibly wrapped) history,
    with one pair masked as skipped, within 1e-12 of the reference's."""
    rng = np.random.default_rng(n_pairs)
    n, m = 6, 4
    S, Y, rho = _history(rng, n, m, n_pairs)
    if n_pairs >= 3:
        rho[(n_pairs - 2) % m] = 0.0  # a skipped (indefinite) pair
    g = rng.normal(size=n)
    ours = torch_lbfgs.lbfgs_direction(
        torch.tensor(g), torch.tensor(S), torch.tensor(Y), torch.tensor(rho),
        n_pairs, m).numpy()
    ref = np.asarray(ref_lbfgs.lbfgs_direction(
        jnp.asarray(g), jnp.asarray(S), jnp.asarray(Y), jnp.asarray(rho),
        jnp.asarray(n_pairs), m))
    assert np.max(np.abs(ours - ref)) <= 1e-12 * max(np.max(np.abs(ref)), 1)


LINE_SEARCH_CASES = [
    # (name, phi(t, m), dphi(t, m), step 0): scalar objectives along the
    # search direction, ``m`` the array module (numpy or jax.numpy)
    ("quartic", lambda t, m: 0.25 * t**4 - 0.5 * t**2 - 0.1 * t,
     lambda t, m: t**3 - t - 0.1, 1.0),
    ("quadratic", lambda t, m: (t - 1.7) ** 2,
     lambda t, m: 2 * (t - 1.7), 1.0),
    ("steep", lambda t, m: -t + 50.0 * t**2 / 2,
     lambda t, m: -1 + 50.0 * t, 1.0),
    ("cosine", lambda t, m: m.cos(t + 0.3), lambda t, m: -m.sin(t + 0.3),
     1.0),
    ("quartic_small_step", lambda t, m: 0.25 * t**4 - 0.5 * t**2 - 0.1 * t,
     lambda t, m: t**3 - t - 0.1, 0.05),
]


@pytest.mark.parametrize("case", LINE_SEARCH_CASES, ids=lambda c: c[0])
def test_morethuente_matches_the_reference(case):
    """The same step and the same number of evaluations as the
    reference's search, and the step satisfies strong Wolfe."""
    _name, phi, dphi, stp0 = case

    def fg_torch(x):
        t = float(x[0])
        return (torch.tensor(phi(t, np), dtype=torch.float64),
                torch.tensor([dphi(t, np)], dtype=torch.float64), {})

    def fg_jax(x):
        t = x[0]
        return phi(t, jnp), jnp.array([dphi(t, jnp)]), {"z": jnp.zeros(())}

    f0, dg0 = float(phi(0.0, np)), float(dphi(0.0, np))
    stp, f, _g, _aux, nfev, ok = torch_lbfgs.morethuente_linesearch(
        fg_torch, torch.zeros(1, dtype=torch.float64),
        torch.ones(1, dtype=torch.float64), f0, dg0, stp0, {},
        torch.tensor([dg0], dtype=torch.float64))
    r_stp, r_f, _rg, _raux, r_nfev, r_ok = ref_lbfgs.morethuente_linesearch(
        fg_jax, jnp.zeros(1, dtype=jnp.float64),
        jnp.ones(1, dtype=jnp.float64), f0, dg0, stp0,
        {"z": jnp.zeros(())}, jnp.array([dg0]))
    assert nfev == int(r_nfev) and bool(ok) == bool(r_ok)
    assert abs(float(stp) - float(r_stp)) <= 1e-12 * abs(float(r_stp))
    stp = float(stp)
    assert bool(ok)
    assert float(f) <= f0 + 1e-4 * stp * dg0 + 1e-12  # sufficient decrease
    assert abs(dphi(stp, np)) <= 0.9 * abs(dg0) + 1e-12  # curvature


def _rosenbrock(x):
    a, b = x[0], x[1]
    f = (1 - a) ** 2 + 100.0 * (b - a**2) ** 2
    g = torch.stack([-2 * (1 - a) - 400.0 * a * (b - a**2),
                     200.0 * (b - a**2)])
    return f, g, {}


def test_lbfgs_iter_converges_rosenbrock_as_scipy():
    """Direction, line search and history together drive the 2-D
    Rosenbrock function to the minimum scipy's L-BFGS-B finds."""
    from scipy.optimize import minimize

    init_state, step = torch_lbfgs.make_lbfgs_iter(_rosenbrock, n=2, m=10)
    x = torch.tensor([-1.2, 1.0], dtype=torch.float64)
    st = init_state(x)
    f, g, aux = _rosenbrock(x)
    n_eval = 1
    for _ in range(60):
        x, st, f, g, aux, _alpha, nfev = step(x, st, f, g, aux)
        n_eval += nfev
    ref = minimize(lambda z: _rosenbrock(torch.tensor(z))[0].item(),
                   [-1.2, 1.0], method="L-BFGS-B",
                   jac=lambda z: _rosenbrock(torch.tensor(z))[1].numpy(),
                   options={"ftol": 1e-15, "gtol": 1e-12})
    assert float(f) < 1e-12
    assert np.max(np.abs(x.numpy() - ref.x)) < 1e-5
    assert np.max(np.abs(x.numpy() - 1.0)) < 1e-6
    assert n_eval < 2 * 60  # about one evaluation an iteration


def test_lbfgs_iter_respects_bounds_as_scipy():
    """Box bounds by projection: every iterate inside the box, and the
    bound-constrained quadratic at scipy's constrained optimum."""
    from scipy.optimize import minimize

    A = torch.tensor(np.diag([1.0, 10.0]))
    b = torch.tensor([3.0, 3.0], dtype=torch.float64)

    def fg(x):
        return 0.5 * x @ A @ x - b @ x, A @ x - b, {}

    lower = torch.tensor([-1.0, -1.0], dtype=torch.float64)
    upper = torch.tensor([1.0, 1.0], dtype=torch.float64)
    init_state, step = torch_lbfgs.make_lbfgs_iter(
        fg, n=2, m=10, lower=lower, upper=upper)
    x = torch.zeros(2, dtype=torch.float64)
    st = init_state(x)
    f, g, aux = fg(x)
    for _ in range(25):
        x, st, f, g, aux, _a, _n = step(x, st, f, g, aux)
        assert bool(torch.all(x >= lower - 1e-12))
        assert bool(torch.all(x <= upper + 1e-12))
    ref = minimize(lambda z: fg(torch.tensor(z))[0].item(), [0.0, 0.0],
                   jac=lambda z: fg(torch.tensor(z))[1].numpy(),
                   method="L-BFGS-B", bounds=[(-1, 1), (-1, 1)])
    np.testing.assert_allclose(x.numpy(), ref.x, atol=1e-6)
    np.testing.assert_allclose(x.numpy(), [1.0, 0.3], atol=1e-6)


# --------------------------------------------------------------------------
# scipy L-BFGS-B
# --------------------------------------------------------------------------

SCIPY_CASES = {
    # (past iteration 5 J_T is at rounding level, where scipy's relative
    # reduction test stops each package at a different iteration)
    "defaults": dict(iter_stop=5),
    # the options: a projected-gradient tolerance that ends the run before
    # iter_stop (scipy's own message), a shorter memory, the trace printed
    "options": dict(iter_stop=40, f_tol=1e-14, g_tol=1e-5, show_trace=True,
                    scipy_options={"maxcor": 5}),
}


@pytest.mark.parametrize("case", sorted(SCIPY_CASES))
def test_scipy_lbfgsb_matches_the_reference(case):
    kw = dict(optimizer="scipy-lbfgsb", **SCIPY_CASES[case])
    res, series, _ = _run(gt, **kw)
    ref, ref_series, _ = _run(grape_tpu, **kw)
    assert res.iter == ref.iter and res.message == ref.message
    assert len(series) == len(ref_series) == res.iter + 1
    np.testing.assert_allclose(series, ref_series, rtol=0,
                               atol=1e-10 * ref_series[0])
    if case == "options":
        assert res.iter < 40 and "PROJECTED GRADIENT" in res.message
    else:
        assert res.message == "Reached maximum number of iterations"


def test_scipy_x_tol_warns_and_abnormal_exit_is_explained():
    from grape_tpu_torch.optimizers.scipy_backend import ScipyLBFGSB

    with pytest.warns(UserWarning, match="x_tol"):
        ScipyLBFGSB({"x_tol": 1e-8})

    class Res:
        message = "ABNORMAL_TERMINATION_IN_LNSRCH"
        fun = 0.5

    class Wrk:
        gradient = np.ones(3)

    with pytest.warns(UserWarning, match="terminated abnormally"):
        ScipyLBFGSB._postmortem(Res(), Wrk())


# --------------------------------------------------------------------------
# a user's backend, and the fallback to scipy
# --------------------------------------------------------------------------

class _SteepestDescent:
    """A user's backend: fixed-step gradient descent through the driver
    protocol."""

    def __init__(self, lr):
        self.lr = lr
        self.runs = 0

    def run(self, wrk, fg, callback, check_convergence):
        from grape_tpu_torch.optimize import (
            apply_convergence_check, update_result,
        )

        self.runs += 1
        x = wrk.pulsevals
        g = np.zeros_like(x)
        fg(0.0, g, x)
        update_result(wrk, 0)
        callback(wrk, 0)
        while not wrk.result.converged:
            x -= self.lr * g
            fg(0.0, g, x)
            update_result(wrk, wrk.result.iter + 1)
            callback(wrk, wrk.result.iter)
            apply_convergence_check(wrk.result, check_convergence)


def test_custom_backend_object_is_passed_through():
    from grape_tpu_torch.optimize import _get_optimizer

    backend = _SteepestDescent(lr=2.0)
    res, series, _ = _run(gt, optimizer=backend, iter_stop=4)
    assert backend.runs == 1 and res.iter == 4
    assert np.all(np.diff(series) < 0)

    class Wrk:
        kwargs = {"optimizer": backend}

    assert _get_optimizer(Wrk()) is backend


def test_native_backend_falls_back_to_scipy_unless_named(monkeypatch):
    from grape_tpu_torch.optimize import _get_optimizer
    from grape_tpu_torch.optimizers import lbfgsb
    from grape_tpu_torch.optimizers.scipy_backend import ScipyLBFGSB

    class Wrk:
        def __init__(self, opt):
            self.kwargs = {} if opt is None else {"optimizer": opt}
            self.cp = type("CP", (), {"device": torch.device("cpu"),
                                      "fw_prop_callback": None})()

    def no_compiler():
        raise OSError("g++ not found")

    monkeypatch.setattr(lbfgsb, "_load", no_compiler)
    assert isinstance(_get_optimizer(Wrk(None)), ScipyLBFGSB)
    assert isinstance(_get_optimizer(Wrk("auto")), ScipyLBFGSB)
    with pytest.raises(OSError, match="g\\+\\+"):
        _get_optimizer(Wrk("lbfgsb"))
