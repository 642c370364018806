"""Nonlinear amplitudes (``CustomAmplitude``) through ``grape_tpu_torch``
against ``grape_tpu``: each side builds the same problem from the same
numpy operators and a pair of amplitude functions, one in ``jax.numpy``,
one in ``torch``.

Tolerances: complex128 — J to 1e-12, the gradient to 1e-10 of its largest
entry against the reference, and to 1e-10 absolute against fourth-order
central finite differences of the port's own ``J`` (the reference's
anchor for nonlinear amplitudes, ``tests/test_custom_amplitude.py``); the
envelope, the squaring count and the Taylor order count exactly equal
(the same sample points, evaluated in float64 on both sides)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grape_tpu
from grape_tpu.fg import _coeff_env as ref_coeff_env
from grape_tpu.fg import _pallas_squarings as ref_squarings
from grape_tpu.fg import _vectorized_taylor_orders as ref_taylor_orders
from grape_tpu.fg import build_fg as ref_build_fg
from grape_tpu.fg import compile_problem as ref_compile_problem
from grape_tpu.functionals import J_T_sm as ref_J_T_sm

import grape_tpu_torch
from grape_tpu_torch import build_f, build_fg, compile_problem
from grape_tpu_torch.fg import (
    _coeff_env, _static_squarings, _vectorized_taylor_orders,
)
from grape_tpu_torch.functionals import J_T_sm

torch.set_num_threads(1)

sx = np.array([[0, 1], [1, 0]], dtype=complex)
sy = np.array([[0, -1j], [1j, 0]], dtype=complex)
sz = np.array([[1, 0], [0, -1]], dtype=complex)
A = 0.8


def _guess_sin(t):
    return 0.4 * np.sin(np.pi * t / 3.0)


def _guess_cos(t):
    return 0.3 + 0.2 * np.cos(t)


def _eps1(t):
    return 0.4


def _eps2(t):
    return 0.2 * t


def _eps_squared(pkg, n_steps=40):
    amp = pkg.CustomAmplitude(lambda v, t: v[0] ** 2, _guess_sin)
    H = pkg.hamiltonian(-0.5 * sz, (sx, amp))
    return [pkg.Trajectory([1, 0], H, target_state=[0, 1])], n_steps


def _trig_bounded(pkg, n_steps=40):
    sin = jnp.sin if pkg is grape_tpu else torch.sin
    amp = pkg.CustomAmplitude(
        lambda v, t: A * sin(v[0]), _guess_cos,
        bound=lambda amp_max: (A, np.asarray([A])),
    )
    H = pkg.hamiltonian(-0.5 * sz, (sx, amp))
    return [pkg.Trajectory([1, 0], H, target_state=[0, 1])], n_steps


def _two_controls(pkg, n_steps=30):
    cos = jnp.cos if pkg is grape_tpu else torch.cos
    amp = pkg.CustomAmplitude(lambda v, t: v[0] * cos(v[1]), (_eps1, _eps2))
    H = pkg.hamiltonian(-0.5 * sz, (sx, amp), (sy, _eps1))
    return [pkg.Trajectory([1, 0], H, target_state=[0, 1])], n_steps


_AMPS = {"eps_squared": _eps_squared, "trig_bounded": _trig_bounded,
         "two_controls": _two_controls}


def _compiled(name, pkg, **kw):
    trajs, n_steps = _AMPS[name](pkg)
    tlist = np.linspace(0.0, 3.0, n_steps + 1)
    if pkg is grape_tpu:
        return ref_compile_problem(trajs, tlist, J_T=ref_J_T_sm, **kw)
    return compile_problem(trajs, tlist, J_T=J_T_sm, device="cpu", **kw)


def _pulse(cp, scale=0.5):
    rng = np.random.default_rng(42)
    return scale * rng.normal(size=cp.n_controls * cp.n_timesteps)


@pytest.mark.parametrize("method", ["gradgen", "taylor"])
@pytest.mark.parametrize("name", sorted(_AMPS))
def test_custom_amplitude_matches_reference_and_fd(name, method):
    cp = _compiled(name, grape_tpu_torch, gradient_method=method)
    cp_r = _compiled(name, grape_tpu, gradient_method=method)
    assert [j for j, _, _ in cp.custom_terms] == [
        j for j, _, _ in cp_r.custom_terms]
    x = _pulse(cp)
    J, G, _ = build_fg(cp)(x)
    J_r, G_r, _ = ref_build_fg(cp_r)(x)
    G, G_r = G.numpy(), np.asarray(G_r)
    assert abs(float(J) - float(J_r)) < 1e-12
    assert np.max(np.abs(G - G_r)) < 1e-10 * np.max(np.abs(G_r))
    f = build_f(cp)

    def J_of(xv):
        return float(f(xv)[0])

    rng = np.random.default_rng(42)
    idx = rng.choice(len(x), size=6, replace=False)
    h = 1e-4
    for i in idx:
        e = np.zeros_like(x)
        e[i] = h
        fd = (8.0 * (J_of(x + e) - J_of(x - e))
              - (J_of(x + 2 * e) - J_of(x - 2 * e))) / (12.0 * h)
        assert abs(G[i] - fd) < 1e-10, (i, G[i], fd)


@pytest.mark.parametrize("name", sorted(_AMPS))
def test_envelope_and_static_counts_equal_the_reference(name):
    """The sampled (or analytic) coefficient envelope, the kernels'
    squaring count and the Taylor order count: the reference's."""
    cp = _compiled(name, grape_tpu_torch, dtype=np.complex64)
    cp_r = _compiled(name, grape_tpu, dtype=np.complex64)
    for scale in (1.0, 2.0, 8.0):
        amp_max = scale * np.maximum(
            np.max(np.abs(cp.guess_pulsevals), axis=1), 0.1)
        cmax, dmax = _coeff_env(cp, amp_max)
        cmax_r, dmax_r = ref_coeff_env(cp_r, amp_max)
        assert np.array_equal(cmax, cmax_r) and np.array_equal(dmax, dmax_r)
        assert _static_squarings(cp, amp_max) == ref_squarings(cp_r, amp_max)
        assert (_vectorized_taylor_orders(cp, amp_max)
                == ref_taylor_orders(cp_r, amp_max))


@pytest.mark.parametrize("method", ["gradgen", "taylor"])
def test_custom_amplitude_per_step_pass(method):
    kw = dict(gradient_method=method, vectorize_backward=False,
              reuse_propagators=False)
    cp = _compiled("eps_squared", grape_tpu_torch, **kw)
    cp_r = _compiled("eps_squared", grape_tpu, **kw)
    x = _pulse(cp)
    J, G, aux = build_fg(cp)(x)
    J_r, G_r, _ = ref_build_fg(cp_r)(x)
    assert bool(aux["taylor_ok"])
    assert abs(float(J) - float(J_r)) < 1e-12
    assert np.max(np.abs(G.numpy() - np.asarray(G_r))) < (
        1e-10 * np.max(np.abs(np.asarray(G_r))))


def test_custom_amplitude_cheby_propagation():
    """Chebyshev propagation with a nonlinear amplitude: the sampled
    envelope sizes the spectral range; against the reference and against
    the port's ExpProp."""
    cp = _compiled("eps_squared", grape_tpu_torch, prop_method="cheby")
    cp_r = _compiled("eps_squared", grape_tpu, prop_method="cheby")
    cp_e = _compiled("eps_squared", grape_tpu_torch)
    x = cp.guess_pulsevals.reshape(-1)
    J, G, _ = build_fg(cp)(x)
    J_r, G_r, _ = ref_build_fg(cp_r)(x)
    J_e, G_e, _ = build_fg(cp_e)(x)
    assert abs(float(J) - float(J_r)) < 1e-12
    assert np.max(np.abs(G.numpy() - np.asarray(G_r))) < (
        1e-10 * np.max(np.abs(np.asarray(G_r))))
    assert abs(float(J) - float(J_e)) < 1e-12
    assert float((G - G_e).abs().max()) < 1e-10


def test_custom_amplitude_optimize():
    """Five L-BFGS-B iterations through the trig-bounded parametrization:
    the J_T series equal to the reference's to 1e-8."""
    series = {}
    for pkg in (grape_tpu_torch, grape_tpu):
        trajs, _ = _trig_bounded(pkg)
        tlist = np.linspace(0.0, 3.0, 41)
        seen = []
        extra = {"device": "cpu"} if pkg is grape_tpu_torch else {}
        pkg.optimize(
            trajs, tlist, J_T=J_T_sm if pkg is grape_tpu_torch
            else ref_J_T_sm, iter_stop=5, print_iters=False,
            rethrow_exceptions=True,
            callback=lambda wrk, it: seen.append(float(wrk.J_parts[0])),
            **extra)
        series[pkg.__name__] = np.asarray(seen)
    assert len(series["grape_tpu"]) == 6
    assert np.max(np.abs(series["grape_tpu_torch"]
                         - series["grape_tpu"])) < 1e-8
