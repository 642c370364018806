"""State running costs through ``grape_tpu_torch``: ``make_xi``, ``J_b``,
the ``ξ`` source of the co-state chain, and the reference's warnings,
against ``grape_tpu`` on the same problems.

The trap pinned here is the one of χ: ``jax.grad`` of a real function of a
complex Ψ returns conj(∂/∂Re + i∂/∂Im), so the reference writes
``ξ = -½ conj(g)``; torch's gradient is ∂/∂Re + i∂/∂Im itself, so the port
writes ``ξ = -½ g`` with no conjugation.

Tolerances: complex128 — ξ to 1e-14 (one product, BASELINE.md:20), J to
1e-12, the gradient to 1e-10 of its largest entry, the J_T series of five
L-BFGS-B iterations to 1e-8 (the same arithmetic, sums in another order,
amplified by the line search)."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grape_tpu
from grape_tpu.fg import build_fg as ref_build_fg
from grape_tpu.fg import compile_problem as ref_compile_problem
from grape_tpu.functionals import J_b as ref_J_b
from grape_tpu.functionals import make_xi as ref_make_xi
from grape_tpu.models import transmon_qutrit_problem as ref_qutrit_problem

import grape_tpu_torch
from grape_tpu_torch import build_fg, compile_problem
from grape_tpu_torch.functionals import J_b, make_xi
from grape_tpu_torch.models import transmon_qutrit_problem

torch.set_num_threads(1)


def _psd(rng, N):
    A = rng.normal(size=(N, N)) + 1j * rng.normal(size=(N, N))
    return A @ A.conj().T / N  # PSD => g_b >= 0


def test_make_xi_has_no_conjugation():
    """``make_xi`` (torch.func) equals the analytic ``-D Ψ`` and the
    reference's ``make_xi`` (jax.grad, conjugated) to 1e-14."""
    rng = np.random.default_rng(5)
    N, K = 6, 2
    D = _psd(rng, N)
    Psi = rng.normal(size=(K, N)) + 1j * rng.normal(size=(K, N))
    Dt = torch.as_tensor(D)
    Dj = jnp.asarray(D)

    def g_b(P, trajectories, tlist, n):
        return torch.real(torch.einsum("ki,ij,kj->k", torch.conj(P), Dt, P))

    def g_b_ref(P, trajectories, tlist, n):
        return jnp.real(jnp.einsum("ki,ij,kj->k", jnp.conj(P), Dj, P))

    tl = np.linspace(0, 1, 11)
    got = make_xi(g_b, None)(torch.as_tensor(Psi), None,
                             torch.as_tensor(tl), 1).numpy()
    want = -np.einsum("ij,kj->ki", D, Psi)
    ref = np.asarray(ref_make_xi(g_b_ref, None)(jnp.asarray(Psi), None,
                                                jnp.asarray(tl), 1))
    assert np.linalg.norm(got - want) < 1e-14
    assert np.linalg.norm(got - ref) < 1e-14
    # J_b: the trapezoid sum over stored states, as the reference's
    storage = rng.normal(size=(11, K, N)) + 1j * rng.normal(size=(11, K, N))
    jb = float(J_b(torch.as_tensor(storage), None, torch.as_tensor(tl), g_b))
    jb_ref = float(ref_J_b(jnp.asarray(storage), None, jnp.asarray(tl),
                           g_b_ref))
    assert abs(jb - jb_ref) < 1e-12 * abs(jb_ref)


def test_qutrit_analytic_xi_is_make_xi():
    """BASELINE config 3: the analytic ``ξ = -P_guard Ψ`` of the model is
    the ``make_xi`` of its ``g_b`` (1e-14, complex128)."""
    problem = transmon_qutrit_problem()
    g_b, xi = problem.kwargs["g_b"], problem.kwargs["xi"]
    rng = np.random.default_rng(2)
    Psi = torch.as_tensor(rng.normal(size=(2, 3)) + 1j * rng.normal(size=(2, 3)))
    tl = torch.as_tensor(problem.tlist)
    auto = make_xi(g_b, problem.trajectories)(Psi, None, tl, 7)
    assert float((auto - xi(Psi, None, tl, 7)).abs().max()) < 1e-14
    assert float((auto[:, :2]).abs().max()) == 0.0


def _fg_pair(pkg_problem, ref_problem, **kw):
    p = pkg_problem()
    cp = compile_problem(p.trajectories, p.tlist, device="cpu",
                         **{**p.kwargs, **kw})
    r = ref_problem()
    cp_r = ref_compile_problem(r.trajectories, r.tlist,
                               **{**r.kwargs, **kw})
    x = cp.guess_pulsevals.reshape(-1)
    J, g, aux = build_fg(cp)(x)
    J_r, g_r, aux_r = ref_build_fg(cp_r)(x)
    return (float(J), g.numpy(), aux["J_parts"].numpy(), float(J_r),
            np.asarray(g_r), np.asarray(aux_r["J_parts"]))


@pytest.mark.parametrize("case", [
    {}, {"gradient_method": "taylor"},
    {"vectorize_backward": False},
    {"gradient_method": "taylor", "vectorize_backward": False},
    {"xi": None},
], ids=["gradgen", "taylor", "gradgen_per_step", "taylor_per_step",
        "make_xi"])
def test_qutrit_fg_matches_reference(case):
    """The config-3 evaluation (d = 3, K = 2, N_T = 400) with its guard
    running cost: J, J_parts and the gradient against the reference, on
    every backward pass; ``xi=None`` derives ξ by ``make_xi`` on both
    sides."""
    J, g, parts, J_r, g_r, parts_r = _fg_pair(
        transmon_qutrit_problem, ref_qutrit_problem, **case)
    assert parts[2] > 0  # λ_b·J_b
    assert abs(J - J_r) < 1e-12
    assert np.allclose(parts, parts_r, rtol=1e-12, atol=1e-15)
    assert np.max(np.abs(g - g_r)) < 1e-10 * np.max(np.abs(g_r))


def test_qutrit_optimize_series_matches_reference():
    """Five L-BFGS-B iterations of config 3: the J_T series equal to the
    reference's to 1e-8, J_b reported and positive."""
    series = {}
    for pkg, make in ((grape_tpu_torch, transmon_qutrit_problem),
                      (grape_tpu, ref_qutrit_problem)):
        seen = []
        extra = {"device": "cpu"} if pkg is grape_tpu_torch else {}
        res = pkg.optimize_problem(
            make(), iter_stop=5, print_iters=False, rethrow_exceptions=True,
            callback=lambda wrk, it: seen.append(
                (float(wrk.J_parts[0]), float(wrk.J_parts[2]))),
            **extra)
        series[pkg.__name__] = np.asarray(seen)
        assert res.J_b > 0
    mine, ref = series["grape_tpu_torch"], series["grape_tpu"]
    assert mine.shape == ref.shape == (6, 2)
    assert np.max(np.abs(mine - ref)) < 1e-8
    assert mine[-1, 0] < mine[0, 0]


def test_running_cost_warnings():
    """The reference's warnings: ``g_b`` under ``lambda_b = 0`` and ``xi``
    without ``g_b`` are ignored, with its messages."""
    p = transmon_qutrit_problem()
    r = ref_qutrit_problem()
    kw = {k: v for k, v in p.kwargs.items()
          if k not in ("g_b", "xi", "lambda_b")}
    kw_r = {k: v for k, v in r.kwargs.items()
            if k not in ("g_b", "xi", "lambda_b")}
    cases = [
        (dict(g_b=p.kwargs["g_b"], lambda_b=0.0),
         dict(g_b=r.kwargs["g_b"], lambda_b=0.0)),
        (dict(xi=p.kwargs["xi"]), dict(xi=r.kwargs["xi"])),
    ]
    for mine, ref in cases:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            cp = compile_problem(p.trajectories, p.tlist, device="cpu",
                                 **kw, **mine)
        with warnings.catch_warnings(record=True) as caught_r:
            warnings.simplefilter("always")
            ref_compile_problem(r.trajectories, r.tlist, **kw_r, **ref)
        assert cp.g_b is None and cp.xi is None
        msgs = [str(w.message) for w in caught]
        assert msgs and msgs == [str(w.message) for w in caught_r]
