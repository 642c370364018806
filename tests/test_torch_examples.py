"""The port's examples (``grape_tpu_torch/examples``: ``examples/01``–``07``
and the walkthrough of ``docs/tutorial.md``) on the CPU in complex128.

Each ``main`` runs with the example's own settings and checks the
example's own assertions (the tutorial with the iteration budget
``tests/test_tutorial.py`` gives it).  Beside it, J and the gradient at the
guess of the example's problem (``setup()``) are held against the same
problem built with ``grape_tpu`` here, to 1e-12 and 1e-10 (complex128, the
same arithmetic, sums in another order).  Example 03's sharded evaluation
runs in the gloo world of 2 of ``tests/test_torch_distributed.py``."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grape_tpu
import grape_tpu.models
from grape_tpu.fg import build_fg as ref_build_fg
from grape_tpu.fg import compile_problem as ref_compile_problem

import grape_tpu_torch as gt

torch.set_num_threads(1)

SZ = np.array([[1, 0], [0, -1]], dtype=complex)
SX = np.array([[0, 1], [1, 0]], dtype=complex)


def _flattop(pkg, t, **kw):
    return float(importlib.import_module(f"{pkg.__name__}.shapes").flattop(
        t, **kw))


def _tls(pkg, amp=None, J_T="J_T_sm"):
    """Examples 01 and 07 (and, with its amplitude, 05)."""
    if amp is None:
        def amp(t):
            return 0.2 * _flattop(pkg, t, T=5, t_rise=0.3, func="blackman")
    H = pkg.hamiltonian(-0.5 * SZ, (SX, amp))
    fn = getattr(importlib.import_module(f"{pkg.__name__}.functionals"),
                 J_T)
    return ([pkg.Trajectory([1, 0], H, target_state=[0, 1])],
            np.linspace(0, 5, 501), {"J_T": fn})


def _ref_stirap():
    from grape_tpu.functionals import J_T_ss
    from grape_tpu.shapes import blackman

    dP = dS = 0.5
    H0 = np.diag([0.0, dP, dP - dS]).astype(complex)
    HP_re = 0.5 * np.array([[0, 1, 0], [1, 0, 0], [0, 0, 0]], dtype=complex)
    HP_im = 0.5 * np.array([[0, 1j, 0], [-1j, 0, 0], [0, 0, 0]],
                           dtype=complex)
    HS_re = 0.5 * np.array([[0, 0, 0], [0, 0, 1], [0, 1, 0]], dtype=complex)
    HS_im = 0.5 * np.array([[0, 0, 0], [0, 0, 1j], [0, -1j, 0]],
                           dtype=complex)
    H = grape_tpu.hamiltonian(
        H0, (HP_re, lambda t: float(blackman(t, 1.0, 5.0))),
        (HP_im, lambda t: 0.0),
        (HS_re, lambda t: float(blackman(t, 0.0, 4.0))),
        (HS_im, lambda t: 0.0))
    traj = grape_tpu.Trajectory([1, 0, 0], H, target_state=[0, 0, 1])
    return [traj], np.linspace(0, 5, 501), {
        "J_T": J_T_ss, "lambda_b": 0.4,
        "g_b": lambda Psi, trajectories, tl, n: jnp.abs(Psi[..., 1]) ** 2}


def _ref_nonlinear():
    amp = grape_tpu.CustomAmplitude(
        lambda v, t: 1.2 * jnp.sin(v[0]),
        lambda t: 0.3 * _flattop(grape_tpu, t, T=5.0, t_rise=0.3,
                                 func="blackman"),
        bound=lambda amp_max: (1.2, np.asarray([1.2])))
    return _tls(grape_tpu, amp=amp, J_T="J_T_ss")


def _ref_model(name, **kw):
    p = getattr(grape_tpu.models, name)(**kw)
    return p.trajectories, p.tlist, {
        k: v for k, v in p.kwargs.items() if k != "iter_stop"}


def _ref_ensemble():
    trajs = grape_tpu.models.transmon_ensemble_trajectories(
        16, d=3, delta_spread=0.05, T=20.0)
    from grape_tpu.functionals import J_T_sm

    return trajs, np.linspace(0, 20.0, 201), {
        "J_T": J_T_sm, "gradient_method": "taylor"}


def _ref_tutorial():
    from grape_tpu.amplitudes import ShapedAmplitude
    from grape_tpu.functionals import J_T_sm
    from grape_tpu.shapes import flattop

    d = 3
    b = np.diag(np.sqrt(np.arange(1, d)), 1)
    b1, b2 = np.kron(b, np.eye(d)), np.kron(np.eye(d), b)
    n1, n2 = b1.T.conj() @ b1, b2.T.conj() @ b2
    tlist = np.linspace(0.0, 100.0, 501)
    drive = ShapedAmplitude(0.05 * np.ones(500),
                            shape=flattop(tlist, T=100.0, t_rise=10.0))
    H0 = (0.5 * n2 - (n1 @ n1 - n1) - (n2 @ n2 - n2)
          + 0.02 * (b1.T.conj() @ b2 + b2.T.conj() @ b1))
    H = grape_tpu.hamiltonian(H0, (b1 + b1.T.conj(), drive))
    basis = np.eye(d * d, dtype=complex)[:4]
    targets = np.diag([1, 1, 1, -1]).astype(complex).conj().T @ basis
    return [grape_tpu.Trajectory(b0, H, target_state=t0)
            for b0, t0 in zip(basis, targets)], tlist, {"J_T": J_T_sm}


# (module, main, setup, the reference's problem)
CASES = {
    "01_tls_state_transfer": ("tls_state_transfer", "main", "setup",
                              lambda: _tls(grape_tpu)),
    "02_stirap_guard_penalty": ("stirap_guard_penalty", "main", "setup",
                                _ref_stirap),
    "03_robust_ensemble": ("robust_ensemble", "main", "setup",
                           _ref_ensemble),
    "03_robust_gate": ("robust_ensemble", "main_robust_gate",
                       "setup_robust_gate", lambda: _ref_model(
                           "two_transmon_cz_ensemble_problem", n_samples=4,
                           d=4, T=25.0, n_steps=250)),
    "04_xgate_observables": ("xgate_observables", "main", "setup",
                             lambda: _ref_model("tls_xgate_problem",
                                                n_steps=500, lambda_a=1e-4)),
    "05_nonlinear_amplitude": ("nonlinear_amplitude", "main", "setup",
                               _ref_nonlinear),
    "06_subspace_gate_fat_batch": (
        "subspace_gate_fat_batch", "main", "setup",
        lambda: _ref_model("two_transmon_subspace_gate_problem", d=3,
                           n_basis=6, n_steps=100, T=10.0, E0=0.2, J=0.3)),
    "07_krotov_continuation": ("krotov_continuation", "main", "setup",
                               lambda: _tls(grape_tpu)),
}


def _example(module):
    return importlib.import_module(f"grape_tpu_torch.examples.{module}")


def _fg_at_guess(setup, ref_problem):
    """J and the gradient at the guess through both packages."""
    trajs, tlist, kw = setup()[:3]
    cp = gt.compile_problem(trajs, tlist, device="cpu", **kw)
    x = cp.guess_pulsevals.reshape(-1)
    J, g, _ = gt.build_fg(cp)(x)
    rtrajs, rtlist, rkw = ref_problem()
    rcp = ref_compile_problem(rtrajs, rtlist, **rkw)
    assert np.array_equal(np.asarray(rcp.guess_pulsevals),
                          cp.guess_pulsevals)
    Jr, gr, _ = ref_build_fg(rcp)(x)
    return float(J), g.numpy(), float(Jr), np.asarray(gr)


@pytest.mark.parametrize("case", sorted(CASES))
def test_example_runs_through_the_port(case):
    module, main, setup, ref_problem = CASES[case]
    mod = _example(module)
    result = getattr(mod, main)(device="cpu")
    assert result.iter >= 1 and np.isfinite(result.J_T)
    J, g, Jr, gr = _fg_at_guess(getattr(mod, setup), ref_problem)
    assert abs(J - Jr) < 1e-12
    assert np.max(np.abs(g - gr)) < 1e-10


def test_tutorial_walkthrough_through_the_port():
    """The tutorial's walkthrough with the budget of
    ``tests/test_tutorial.py`` (3 iterations, converged below 0.5): a real
    step with the bounds held, and its problem against the reference's."""
    mod = _example("tutorial")
    result = mod.main(device="cpu", iter_stop=3, converged_below=0.5)
    assert 1 <= result.iter <= 3 and result.fg_calls >= 3
    assert result.J_T < result.records[0][1] if result.records else True
    J, g, Jr, gr = _fg_at_guess(mod.setup, _ref_tutorial)
    assert abs(J - Jr) < 1e-12
    assert np.max(np.abs(g - gr)) < 1e-10
    assert result.J_T < J
