"""The Taylor backward pass, the per-step fallback and ``"auto"``:
``grape_tpu_torch`` against ``grape_tpu`` on bit-identical inputs.

- ``gradgen_step`` / ``taylor_grad_step`` against the reference's functions
  and against an independent operator series for ``∂/∂ε exp(-i H dt)``
  (de Fouquières et al., JMR 212, 412 (2011), Eq. (14)): complex128, to
  1e-12 against the series (the tolerance of the reference's own test) and
  1e-14 against the reference's functions (the same recursion, the same
  order of sums).
- ``build_fg`` with ``gradient_method="taylor"`` against the reference's in
  complex128 for the four generator layouts: J to 1e-12, gradient to 1e-10
  relative (the same recursion in another order of sums), the same ``aux``
  keys, ``taylor_ok`` true; with the vectorized pass and the per-step pass,
  with and without stored propagators, and through the static-operator
  branch (its dimension threshold patched down in both packages).
- complex64: a K = 130, d = 3 ensemble against the reference with its
  Pallas kernels in interpret mode, J to 1e-5 and the gradient to 2e-3 of
  its largest entry (float32 arithmetic over the whole time grid).
"""

import numpy as np
import pytest
import scipy.linalg
import torch

import grape_tpu
from grape_tpu import fg as ref_fg_mod
from grape_tpu.fg import build_fg as ref_build_fg
from grape_tpu.fg import compile_problem as ref_compile_problem
from grape_tpu.functionals import J_T_sm as ref_J_T_sm
from grape_tpu.functionals import (
    make_ensemble_gate_functional as ref_ensemble_functional,
)
from grape_tpu.models import (
    transmon_ensemble_trajectories as ref_transmon_ensemble,
)
from grape_tpu.ops import gradgen_step as ref_gradgen_step
from grape_tpu.ops import taylor_grad_step as ref_taylor_grad_step

import grape_tpu_torch as gt
from grape_tpu_torch import build_fg, compiled_problem_from_numpy
from grape_tpu_torch import fg as port_fg
from grape_tpu_torch.functionals import J_T_sm, make_ensemble_gate_functional
from grape_tpu_torch.models import tls_problem
from grape_tpu_torch.ops.frechet import gradgen_step, taylor_grad_step
from grape_tpu_torch.testing import random_matrix, random_state_vector

from tests.test_torch_ensemble_fg import (
    PROBLEMS as ENSEMBLE_PROBLEMS, _arrays_of, _pulses,
)
from tests.test_torch_fg import _random_shared

torch.set_num_threads(1)

TAYLOR_FIELDS = (
    "gradient_method", "vectorize_backward", "reuse_propagators",
    "taylor_grad_max_order", "taylor_grad_tolerance",
    "taylor_grad_check_convergence",
)


# --------------------------------------------------------------------------
# the per-step functions
# --------------------------------------------------------------------------

def _U_grad(H, mu, dt):
    """∂/∂ε exp(-i H dt) by the independent commutator series (Eq. 14)."""
    U = scipy.linalg.expm(-1j * H * dt)
    C = mu
    terms = [(-1j * dt) * C]
    n, fact = 2, 1.0
    while True:
        C = H @ C - C @ H
        fact *= n
        term = -((1j * dt) ** n / fact) * C
        terms.append(term)
        if np.linalg.norm(term) < 1e-16:
            break
        n += 1
        assert n < 200
    return U @ sum(terms)


@pytest.mark.parametrize("dt", [1.25, -1.25])
@pytest.mark.parametrize("scale", [None, 3.0], ids=["unscaled", "scaled"])
def test_taylor_grad_step_against_operator_series(dt, scale):
    rng = np.random.default_rng(3991576559)
    N = 10
    H0, H1, H2 = (random_matrix(N, rng) for _ in range(3))
    H = H0 + H1 + H2
    psi = random_state_vector(N, rng)
    mus = np.stack([H1, H2])
    expected = np.stack([_U_grad(H, H1, dt) @ psi, _U_grad(H, H2, dt) @ psi])
    got, ok = taylor_grad_step(
        torch.from_numpy(H[None]), torch.from_numpy(mus[None]),
        torch.from_numpy(psi[None]), dt, max_order=200, tolerance=1e-16,
        with_status=True, scale=scale,
    )
    assert bool(ok) and got.dtype == torch.complex128
    assert np.linalg.norm(expected - got.numpy()[0]) < 1e-12
    ref = np.asarray(ref_taylor_grad_step(
        H[None], mus[None], psi[None], dt, max_order=200, tolerance=1e-16,
        scale=scale,
    ))
    assert np.linalg.norm(ref - got.numpy()) < 1e-14


@pytest.mark.parametrize("dt", [0.8, -0.8])
def test_gradgen_step_against_operator_series(dt):
    rng = np.random.default_rng(12345)
    N = 8
    H, mu = random_matrix(N, rng), random_matrix(N, rng)
    psi = random_state_vector(N, rng)
    chi_prime, chi_new = gradgen_step(
        torch.from_numpy(H[None]), torch.from_numpy(mu[None, None]),
        torch.from_numpy(psi[None]), dt,
    )
    expected = _U_grad(H, mu, dt) @ psi
    assert np.linalg.norm(expected - chi_prime.numpy()[0, 0]) < 1e-12
    U = scipy.linalg.expm(-1j * H * dt)
    assert np.linalg.norm(chi_new.numpy()[0] - U @ psi) < 1e-12
    ref_prime, ref_new = ref_gradgen_step(H[None], mu[None, None], psi[None],
                                          dt)
    assert np.linalg.norm(np.asarray(ref_prime) - chi_prime.numpy()) < 1e-14
    assert np.linalg.norm(np.asarray(ref_new) - chi_new.numpy()) < 1e-14


def test_taylor_and_gradgen_steps_agree_on_a_batch():
    """The two gradient engines on a (K, L) batch, and a generator shared
    by a group of co-states (the broadcast the per-step pass relies on)."""
    rng = np.random.default_rng(99)
    K, L, N = 3, 2, 6
    H = np.stack([random_matrix(N, rng) for _ in range(K)])
    mu = np.stack([np.stack([random_matrix(N, rng) for _ in range(L)])
                   for _ in range(K)])
    chi = np.stack([random_state_vector(N, rng) for _ in range(K)])
    Ht, mut, chit = (torch.from_numpy(x) for x in (H, mu, chi))
    cp_taylor = taylor_grad_step(Ht, mut, chit, -0.3)
    cp_gradgen, _ = gradgen_step(Ht, mut, chit, -0.3)
    assert float((cp_taylor - cp_gradgen).norm()) < 1e-12
    # one generator for all three co-states: (1, 1, d, d) against (1, 3, d)
    grp_t = taylor_grad_step(Ht[:1, None], mut[:1, None], chit[None], -0.3)
    grp_g, new_g = gradgen_step(Ht[:1, None], mut[:1, None], chit[None], -0.3)
    assert grp_t.shape == grp_g.shape == (1, K, L, N)
    for k in range(K):
        one = taylor_grad_step(Ht[:1], mut[:1], chit[k:k + 1], -0.3)
        assert float((grp_t[0, k] - one[0]).norm()) < 1e-14
        assert float((grp_g[0, k] - one[0]).norm()) < 1e-12
    U = scipy.linalg.expm(0.3j * H[0])
    assert np.linalg.norm(new_g.numpy()[0] - chi @ U.T) < 1e-12


@pytest.mark.parametrize("check", [True, False], ids=["checked", "unchecked"])
def test_taylor_grad_step_status(check):
    """A series that cannot converge within ``max_order=3`` reports it;
    with the check off, exactly ``max_order`` terms and status true."""
    rng = np.random.default_rng(4)
    N = 6
    H, mu = 5.0 * random_matrix(N, rng), random_matrix(N, rng)
    psi = random_state_vector(N, rng)
    args = (torch.from_numpy(H[None]), torch.from_numpy(mu[None, None]),
            torch.from_numpy(psi[None]), 1.0)
    got, ok = taylor_grad_step(*args, max_order=3, tolerance=1e-16,
                               check_convergence=check, with_status=True)
    assert bool(ok) is (not check)
    ref, ref_ok = ref_taylor_grad_step(
        H[None], mu[None, None], psi[None], 1.0, max_order=3,
        tolerance=1e-16, check_convergence=check, with_status=True,
    )
    assert bool(ref_ok) == bool(ok)
    assert np.linalg.norm(np.asarray(ref) - got.numpy()) < 1e-12
    # and a generous order converges
    _, ok = taylor_grad_step(*args, max_order=200, with_status=True)
    assert bool(ok)


# --------------------------------------------------------------------------
# build_fg with gradient_method="taylor"
# --------------------------------------------------------------------------

def _shared(pkg):
    trajs, tlist = _random_shared()
    assert pkg is grape_tpu
    return trajs, tlist


LAYOUTS = {
    "shared": (_shared, False),
    "grouped": ENSEMBLE_PROBLEMS["grouped"][::2],
    "distinct": ENSEMBLE_PROBLEMS["distinct"][::2],
    "per_traj_coeffs": ENSEMBLE_PROBLEMS["per_traj_coeffs"][::2],
}

# name -> compile options
VARIANTS = {
    "vectorized": {},
    "per_step": {"vectorize_backward": False},
    "no_reuse": {"reuse_propagators": False},
    "per_step_no_reuse": {"vectorize_backward": False,
                          "reuse_propagators": False},
}


def _both(name, dtype=np.complex128, **options):
    """The reference's fg and the port's for layout ``name`` with
    ``gradient_method="taylor"`` and ``options``."""
    make, ensemble = LAYOUTS[name]
    trajs, tlist = make(grape_tpu)
    cp_ref = ref_compile_problem(
        trajs, tlist, dtype=dtype, gradient_method="taylor",
        J_T=ref_ensemble_functional(4) if ensemble else ref_J_T_sm,
        use_pallas=np.dtype(dtype) == np.complex64, **options,
    )
    cp = compiled_problem_from_numpy(
        _arrays_of(cp_ref), device="cpu",
        J_T=make_ensemble_gate_functional(4) if ensemble else "J_T_sm",
        **{key: getattr(cp_ref, key) for key in TAYLOR_FIELDS},
    )
    for key in TAYLOR_FIELDS:
        assert getattr(cp, key) == getattr(cp_ref, key), key
    return cp_ref, ref_build_fg(cp_ref), cp, build_fg(cp)


def _assert_same_fg(cp_ref, fg_ref, fg, pulses=("guess", "perturbed")):
    for pulse in pulses:
        x = _pulses(cp_ref)[pulse]
        J_ref, g_ref, aux_ref = fg_ref(x)
        J, g, aux = fg(x)
        assert set(aux) == set(aux_ref)
        assert bool(aux["taylor_ok"]) and bool(aux_ref["taylor_ok"])
        assert abs(float(J) - float(J_ref)) < 1e-12
        g, g_ref = g.numpy(), np.asarray(g_ref)
        assert g.shape == g_ref.shape == x.shape
        assert np.max(np.abs(g - g_ref)) < 1e-10 * np.max(np.abs(g_ref)), pulse
        for key in ("J_parts", "chi_norms", "grad_J_Tb"):
            np.testing.assert_allclose(
                aux[key].numpy(), np.asarray(aux_ref[key]), atol=1e-10,
                rtol=0,
            )


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_taylor_fg_complex128_matches_reference(name, variant):
    cp_ref, fg_ref, cp, fg = _both(name, **VARIANTS[variant])
    assert cp.gradient_method == "taylor"
    vectorized = "per_step" not in variant
    assert (
        (port_fg._vectorized_taylor_orders(cp) is not None
         and cp.vectorize_backward) == vectorized
    )
    assert port_fg._reuse_U_enabled(cp) == ("no_reuse" not in variant)
    assert port_fg._vectorized_taylor_orders(cp) == (
        ref_fg_mod._vectorized_taylor_orders(cp_ref)
    )
    # the per-step pass is slow on the CPU: one pulse is enough there
    _assert_same_fg(cp_ref, fg_ref, fg,
                    ("guess", "perturbed") if vectorized else ("perturbed",))


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_taylor_static_operator_branch(name, monkeypatch):
    """At d = 16 with the threshold patched down in both packages the
    static-operator decomposition of H†@Z runs where its column condition
    holds: the same numbers as the reference, and as the materialized
    branch."""
    cp_ref, fg_ref, cp, fg = _both(name)
    x = _pulses(cp_ref)["perturbed"]
    _, g_mat, _ = fg(x)
    monkeypatch.setattr(port_fg, "_STATIC_H_MIN_DIM", 16)
    monkeypatch.setattr(ref_fg_mod, "_STATIC_H_MIN_DIM", 16)
    T = cp.ops.shape[1]
    assert (T + 1) * cp.n_traj * (cp.n_controls + 1) <= 256
    fg_ref = ref_build_fg(cp_ref)  # traced anew under the patch
    _assert_same_fg(cp_ref, fg_ref, fg)
    _, g_static, _ = fg(x)
    assert not torch.equal(g_static, g_mat)  # the other branch did run
    assert float((g_static - g_mat).abs().max()) < 1e-13


def test_host_side_taylor_helpers_match_reference():
    for name in sorted(LAYOUTS):
        cp_ref, _, cp, _ = _both(name)
        for amp in (None, np.full(cp.n_controls, 0.7)):
            for fn in ("_mu_norm_bound", "_taylor_prefactor",
                       "_h_norm_bound"):
                assert getattr(port_fg, fn)(cp, amp) == pytest.approx(
                    getattr(ref_fg_mod, fn)(cp_ref, amp), rel=1e-14), fn
            assert port_fg._vectorized_taylor_orders(cp, amp) == (
                ref_fg_mod._vectorized_taylor_orders(cp_ref, amp))
        assert port_fg._taylor_tol_effective(cp) == 1e-16
        assert port_fg.uses_static_envelope(cp)
        assert ref_fg_mod.uses_static_envelope(cp_ref)


def test_taylor_fg_complex64_smalld_ensemble_matches_reference_kernels():
    """K = 130 qutrits, one generator each: the reference takes its
    small-dimension Pallas kernel (interpret mode) for the forward scan, the
    port the plain version of ``forward_scan_smalld``; both then run the
    vectorized Taylor pass in float32."""
    trajs = ref_transmon_ensemble(130, d=3, T=4.0)
    tlist = np.linspace(0, 4.0, 13)
    cp_ref = ref_compile_problem(
        trajs, tlist, J_T=ref_J_T_sm, dtype=np.complex64,
        gradient_method="taylor", use_pallas=True,
    )
    assert ref_fg_mod._pallas_smalld_enabled(cp_ref, None)
    cp = compiled_problem_from_numpy(
        _arrays_of(cp_ref), device="cpu", J_T="J_T_sm",
        gradient_method="taylor",
    )
    assert port_fg._smalld_enabled(cp) and port_fg._compute_group_size(cp) == 1
    assert port_fg._static_squarings(cp) == ref_fg_mod._pallas_squarings(cp_ref)
    assert port_fg._taylor_tol_effective(cp) == 1e-9
    assert port_fg._vectorized_taylor_orders(cp) == (
        ref_fg_mod._vectorized_taylor_orders(cp_ref))
    fg_ref, fg = ref_build_fg(cp_ref), build_fg(cp)
    for pulse, x in _pulses(cp_ref).items():
        J_ref, g_ref, aux_ref = fg_ref(x)
        J, g, aux = fg(x)
        g, g_ref = g.numpy(), np.asarray(g_ref)
        assert g.dtype == np.float32 and aux["psi_T"].dtype == torch.complex64
        assert bool(aux["taylor_ok"]) and bool(aux_ref["taylor_ok"])
        assert abs(float(J) - float(J_ref)) < 1e-5 * max(1.0, abs(float(J_ref)))
        assert np.max(np.abs(g - g_ref)) < 2e-3 * np.max(np.abs(g_ref)), pulse


# --------------------------------------------------------------------------
# "auto", the budget fallback, the workspace's safety net
# --------------------------------------------------------------------------

def test_auto_resolves_as_the_reference_does():
    from grape_tpu.testing import tls_problem as ref_tls_problem

    p_ref, p = ref_tls_problem(n_steps=50), tls_problem(n_steps=50,
                                                        J_T=J_T_sm)
    cp_ref = ref_compile_problem(p_ref.trajectories, p_ref.tlist,
                                 gradient_method="auto", **p_ref.kwargs)
    cp = gt.compile_problem(p.trajectories, p.tlist, device="cpu",
                            gradient_method="auto", **p.kwargs)
    assert cp.gradient_method == cp_ref.gradient_method == "gradgen"
    # outside the vectorized gradgen regime: taylor, in both packages
    for kw in ({"vectorize_backward": False}, {"reuse_propagators": False}):
        cp_ref = ref_compile_problem(p_ref.trajectories, p_ref.tlist,
                                     gradient_method="auto", **kw,
                                     **p_ref.kwargs)
        cp = gt.compile_problem(p.trajectories, p.tlist, device="cpu",
                                gradient_method="auto", **kw, **p.kwargs)
        assert cp.gradient_method == cp_ref.gradient_method == "taylor", kw
    with pytest.raises(ValueError, match="gradient_method"):
        gt.compile_problem(p.trajectories, p.tlist, device="cpu",
                           gradient_method="adjoint", **p.kwargs)


@pytest.mark.parametrize("method", ["gradgen", "taylor"])
def test_complex128_past_the_u_budget_takes_the_per_step_pass(
        method, monkeypatch):
    """With the propagator-stream budget declared exceeded, a complex128
    gradgen problem has no vectorized pass left and takes the per-step one;
    a taylor problem keeps its vectorized pass over propagators formed
    again.  Either way the reference's gradient (computed within budget)."""
    make, ensemble = LAYOUTS["distinct"]
    trajs, tlist = make(grape_tpu)
    cp_ref = ref_compile_problem(trajs, tlist, dtype=np.complex128,
                                 J_T=ref_J_T_sm, gradient_method=method)
    cp = compiled_problem_from_numpy(
        _arrays_of(cp_ref), device="cpu", J_T="J_T_sm",
        gradient_method=method,
        reuse_propagators=False if method == "taylor" else "auto",
    )
    monkeypatch.setattr(port_fg, "_gg_u_bytes_ok", lambda cp: False)
    assert not port_fg._vec_gradgen_enabled(cp)
    assert not port_fg._reuse_U_enabled(cp)
    _assert_same_fg(cp_ref, ref_build_fg(cp_ref), build_fg(cp),
                    ("perturbed",))


def test_workspace_raises_when_the_taylor_series_cannot_converge():
    """``taylor_grad_max_order=2``: no static order exists, the per-step
    pass reports non-convergence, the workspace grows its bucket once and
    then raises the reference's error."""
    p = tls_problem(n_steps=20, T=5.0, J_T=J_T_sm)
    with pytest.raises(RuntimeError) as err:
        gt.optimize_problem(p, gradient_method="taylor", device="cpu",
                            taylor_grad_max_order=2, print_iters=False,
                            rethrow_exceptions=True, iter_stop=2)
    from grape_tpu.testing import tls_problem as ref_tls_problem

    p_ref = ref_tls_problem(n_steps=20, T=5.0)
    with pytest.raises(RuntimeError) as ref_err:
        grape_tpu.optimize_problem(
            p_ref, gradient_method="taylor", taylor_grad_max_order=2,
            print_iters=False, rethrow_exceptions=True, iter_stop=2)
    assert str(err.value) == str(ref_err.value)
    assert "did not converge within max_order=2" in str(err.value)
    # captured, not raised, without rethrow_exceptions
    res = gt.optimize_problem(p, gradient_method="taylor", device="cpu",
                              taylor_grad_max_order=2, print_iters=False,
                              iter_stop=2)
    assert res.message.startswith("Exception: Taylor gradient series")
    # the check switched off: the truncated series is taken as it is
    res = gt.optimize_problem(p, gradient_method="taylor", device="cpu",
                              taylor_grad_max_order=2, print_iters=False,
                              taylor_grad_check_convergence=False,
                              rethrow_exceptions=True, iter_stop=2)
    assert not res.message.startswith("Exception")


def test_workspace_buckets_only_what_uses_the_envelope():
    from grape_tpu_torch.workspace import GrapeWrk

    p = tls_problem(n_steps=20, T=5.0, J_T=J_T_sm)
    kw = dict(p.kwargs, device="cpu")
    wrk = GrapeWrk(p.trajectories, p.tlist, dict(kw, gradient_method="taylor"))
    assert wrk._amp_bucket is not None
    wrk = GrapeWrk(p.trajectories, p.tlist,
                   dict(kw, gradient_method="taylor",
                        vectorize_backward=False))
    assert wrk._amp_bucket is None and not port_fg.uses_static_envelope(wrk.cp)
    x = wrk.pulsevals.copy()
    J, g = wrk.evaluate_gradient(10.0 * x)  # far past any bucket: no rebuild
    assert np.isfinite(J) and np.all(np.isfinite(g))
