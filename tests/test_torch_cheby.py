"""The Chebyshev propagator of ``grape_tpu_torch`` against ``grape_tpu``.

The numeric pieces first: the host tables (``cheby_coeffs``,
``spectral_envelope``, ``fg._cheby_data``) must be bit-identical to the
reference's, the series ``cheby_apply`` equal to 1e-12 in complex128.  Then
``build_fg`` under ``prop_method="cheby"`` against the reference's on the
same arrays (carried across by ``compiled_problem_from_numpy``): complex128,
J to 1e-12 and the gradient to 1e-10 of its max, for the vectorized Taylor
pass, the per-step Taylor pass and the per-step extended-state gradgen, on a
shared and a per-trajectory generator; complex64 on the Chebyshev-scan
kernel's route (dim 256; here its plain version) against the reference's
Pallas kernels in interpret mode, J to 1e-5 and the gradient to 1e-4 of its
max.  Last the optimization anchors: the TLS with Chebyshev propagation, the
CNOT Chebyshev golden series, and an envelope bucket that grows."""

import json
import os

import numpy as np
import pytest
import scipy.linalg
import torch

import jax.numpy as jnp

import grape_tpu
from grape_tpu import fg as ref_fg
from grape_tpu.functionals import J_T_sm as ref_J_T_sm
from grape_tpu.models import two_transmon_cz_problem as ref_cz_problem
from grape_tpu.ops.cheby import cheby_apply as ref_cheby_apply
from grape_tpu.ops.cheby import cheby_coeffs as ref_cheby_coeffs
from grape_tpu.ops.cheby import spectral_envelope as ref_spectral_envelope
from grape_tpu.workspace import GrapeWrk as RefGrapeWrk

import grape_tpu_torch as gt
from grape_tpu_torch import build_f, build_fg, compiled_problem_from_numpy
from grape_tpu_torch import fg as port_fg
from grape_tpu_torch.functionals import J_T_sm
from grape_tpu_torch.ops.cheby import (
    cheby_apply, cheby_coeffs, spectral_envelope,
)
from grape_tpu_torch.testing import cnot_problem
from grape_tpu_torch.workspace import GrapeWrk

from tests.test_torch_ensemble_fg import _arrays_of, _distinct

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "traces.json")


# --------------------------------------------------------------------------
# The numeric pieces
# --------------------------------------------------------------------------

@pytest.mark.parametrize("tol", [1e-14, 1e-8])
@pytest.mark.parametrize("alpha", [0.1, 5.6, -5.6, 30.0])
def test_cheby_coeffs_exact(alpha, tol):
    got = cheby_coeffs(alpha, tol=tol)
    want = ref_cheby_coeffs(alpha, tol=tol)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_spectral_envelope_exact():
    rng = np.random.default_rng(3)
    d = 6
    H0 = rng.normal(size=(2, d, d)) + 1j * rng.normal(size=(2, d, d))
    H0 = 0.5 * (H0 + np.conj(np.swapaxes(H0, -1, -2)))
    ops = rng.normal(size=(2, 3, d, d))
    ops = 0.5 * (ops + np.swapaxes(ops, -1, -2))
    lo, hi = [-1.5, -0.5, 0.0], [1.5, 0.5, 0.2]
    assert spectral_envelope(H0, ops, lo, hi) == ref_spectral_envelope(
        H0, ops, lo, hi)


def _ref_cz(d=4, n_steps=30, T=5.0, **kw):
    problem = ref_cz_problem(d=d, n_steps=n_steps, T=T)
    kwargs = dict(problem.kwargs)
    kwargs.update(kw)
    return ref_fg.compile_problem(problem.trajectories, problem.tlist,
                                  **kwargs)


PROP_KEYS = ("prop_method", "fw_prop_method", "bw_prop_method",
             "grad_prop_method", "cheby_tol", "newton_m", "newton_substeps")


def _port_of(cp_ref, dtype=None):
    """The port's CompiledProblem on the reference's arrays and settings."""
    return compiled_problem_from_numpy(
        _arrays_of(cp_ref), J_T="J_T_sm", device="cpu", dtype=dtype,
        gradient_method=cp_ref.gradient_method,
        vectorize_backward=cp_ref.vectorize_backward,
        reuse_propagators=cp_ref.reuse_propagators,
        **{key: getattr(cp_ref, key) for key in PROP_KEYS},
    )


@pytest.mark.parametrize("spec", [True, False])
def test_cheby_data_exact(spec):
    """The tables from the compile-time spectral cache and, without it,
    from ``spectral_envelope``: bit-identical to the reference's."""
    cp_ref = _ref_cz(prop_method="cheby")
    cp = _port_of(cp_ref)
    assert "spec" in cp.norm_cache and "spec" in cp_ref.norm_cache
    for key in ("eig_lo", "eig_hi", "op2"):
        assert np.array_equal(cp.norm_cache["spec"][key],
                              cp_ref.norm_cache["spec"][key])
    if not spec:
        del cp.norm_cache["spec"], cp_ref.norm_cache["spec"]
    amp_max = np.array([0.13, 0.1, 0.2, 0.1])
    got = port_fg._cheby_data(cp, amp_max)
    want = ref_fg._cheby_data(cp_ref, amp_max)
    assert got["dE"] == want["dE"] and got["shift"] == want["shift"]
    for key in ("tab_fw", "tab_bw", "ph_fw", "ph_bw"):
        assert got[key].dtype == want[key].dtype
        assert np.array_equal(got[key], want[key]), key
    # the port compiles the same spectral cache itself
    port_problem = gt.models.two_transmon_cz_problem(d=4, n_steps=30, T=5.0)
    cp_own = gt.compile_problem(port_problem.trajectories,
                                port_problem.tlist, device="cpu",
                                prop_method="cheby", **port_problem.kwargs)
    if spec:
        for key in ("eig_lo", "eig_hi", "op2"):
            assert np.array_equal(cp_own.norm_cache["spec"][key],
                                  cp_ref.norm_cache["spec"][key])


@pytest.mark.parametrize("dt", [0.1, 1.7, -0.6])
def test_cheby_apply_against_reference(dt):
    rng = np.random.default_rng(17)
    d, K = 12, 3
    A = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    H = 0.5 * (A + A.conj().T)
    w = np.linalg.eigvalsh(H)
    E_min, E_max = w[0] - 0.1, w[-1] + 0.1
    dE, shift = E_max - E_min, E_max + E_min
    Hn = (2 * H - shift * np.eye(d)) / dE
    coeffs = cheby_coeffs(0.5 * dE * dt)
    phase = np.exp(-1j * 0.5 * shift * dt)
    psi = rng.normal(size=(K, d)) + 1j * rng.normal(size=(K, d))
    Hn_t = torch.tensor(Hn)
    got = cheby_apply(lambda v: v @ Hn_t.T, torch.tensor(psi),
                      coeffs.tolist(), complex(phase)).numpy()
    Hn_j = jnp.asarray(Hn)
    want = np.asarray(ref_cheby_apply(
        lambda v: jnp.einsum("ij,kj->ki", Hn_j, v), jnp.asarray(psi),
        coeffs, phase))
    assert np.max(np.abs(got - want)) < 1e-12
    exact = psi @ scipy.linalg.expm(-1j * H * dt).T
    assert np.max(np.abs(got - exact)) < 1e-11


# --------------------------------------------------------------------------
# build_fg against the reference
# --------------------------------------------------------------------------

def _ref_distinct(**kw):
    """Three trajectories under three different generators, d = 16."""
    trajs, tlist = _distinct(grape_tpu)
    return ref_fg.compile_problem(trajs, tlist, J_T=ref_J_T_sm, **kw)


def fg_parity(cp_ref, tol_J=1e-12, tol_g=1e-10, x=None):
    """J, gradient and ``build_f``'s J of the port against the reference
    on the same pulse; returns the port's ``(J, g, aux)``."""
    cp = _port_of(cp_ref)
    if x is None:
        rng = np.random.default_rng(5)
        x = cp_ref.guess_pulsevals.reshape(-1)
        x = x + 0.01 * rng.normal(size=x.shape)
    J_r, g_r, aux_r = ref_fg.build_fg(cp_ref)(x)
    J, g, aux = build_fg(cp)(x)
    J_f, _ = build_f(cp)(x)
    g_r = np.asarray(g_r)
    assert abs(float(J) - float(J_r)) < tol_J
    assert abs(float(J_f) - float(J_r)) < tol_J
    scale = np.max(np.abs(g_r))
    assert np.max(np.abs(g.numpy() - g_r)) < tol_g * scale
    assert bool(aux["taylor_ok"]) == bool(aux_r["taylor_ok"])
    return J, g, aux


PASSES = {
    "taylor_vectorized": dict(gradient_method="taylor"),
    "taylor_per_step": dict(gradient_method="taylor",
                            vectorize_backward=False),
    "gradgen_per_step": dict(gradient_method="gradgen"),
}


@pytest.mark.parametrize("layout", ["shared", "per_trajectory"])
@pytest.mark.parametrize("pass_", sorted(PASSES))
def test_fg_cheby_complex128(pass_, layout):
    kw = dict(prop_method="cheby", **PASSES[pass_])
    cp_ref = _ref_cz(**kw) if layout == "shared" else _ref_distinct(**kw)
    assert cp_ref.shared_generator == (layout == "shared")
    fg_parity(cp_ref)


def test_auto_resolves_to_taylor_under_cheby():
    for kw in (dict(prop_method="cheby"), dict(bw_prop_method="newton"),
               dict(grad_prop_method="cheby")):
        cp_ref = _ref_cz(gradient_method="auto", **kw)
        problem = gt.models.two_transmon_cz_problem(d=4, n_steps=30, T=5.0)
        cp = gt.compile_problem(problem.trajectories, problem.tlist,
                                device="cpu", gradient_method="auto",
                                **problem.kwargs, **kw)
        assert cp_ref.gradient_method == "taylor"
        assert cp.gradient_method == "taylor"
    # all ExpProp at dim 16: gradgen, as in the reference
    cp = gt.compile_problem(problem.trajectories, problem.tlist,
                            device="cpu", gradient_method="auto",
                            **problem.kwargs)
    assert cp.gradient_method == "gradgen"


def _ref_shared_256(**kw):
    """The reference's kernel test problem: d = 256, K = 2, three steps."""
    rng = np.random.default_rng(11)
    d, K = 256, 2
    A = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    B = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))

    def eps(t):
        return 0.2 * np.cos(1.3 * t)

    gen = grape_tpu.hamiltonian(0.3 * (A + A.conj().T),
                                (0.25 * (B + B.conj().T), eps))
    U = np.linalg.qr(rng.normal(size=(d, K)) + 1j * rng.normal(size=(d, K)))[0]
    trajs = [grape_tpu.Trajectory(np.eye(d)[k].astype(complex), gen,
                                  target_state=U[:, k]) for k in range(K)]
    return ref_fg.compile_problem(
        trajs, np.linspace(0, 0.4, 4), J_T=ref_J_T_sm,
        prop_method="cheby", gradient_method="taylor", dtype=np.complex64,
        **kw)


def test_fg_kernel_route_complex64():
    """dim 256, complex64, shared generator: both packages take the
    Chebyshev-scan kernel route in both directions (the port's plain
    version on the CPU, the reference's Pallas kernels in interpret
    mode)."""
    cp_ref = _ref_shared_256(use_pallas=True)
    pd = ref_fg._prop_data(cp_ref)
    assert ref_fg._pallas_cheby_enabled(cp_ref, pd["fw"])
    cp = _port_of(cp_ref)
    pds = port_fg._prop_data(cp)
    assert port_fg._cheby_kernel_enabled(cp, pds["fw"])
    assert port_fg._cheby_kernel_enabled(cp, pds["bw"])
    calls = {"forward": 0, "adjoint": 0}
    original = port_fg.cheby_scan

    def counting(*args, adjoint=False, **kwargs):
        calls["adjoint" if adjoint else "forward"] += 1
        return original(*args, adjoint=adjoint, **kwargs)

    port_fg.cheby_scan = counting
    try:
        x = cp_ref.guess_pulsevals.reshape(-1)
        fg_parity(cp_ref, tol_J=1e-5, tol_g=1e-4, x=x)
    finally:
        port_fg.cheby_scan = original
    # build_fg: forward and adjoint once; build_f: forward once
    assert calls == {"forward": 2, "adjoint": 1}


# --------------------------------------------------------------------------
# Optimization anchors
# --------------------------------------------------------------------------

def _tls():
    def eps(t):
        return 0.2 * float(gt.shapes.flattop(t, T=5, t_rise=0.3,
                                             func="blackman"))

    sz = np.array([[1, 0], [0, -1]], dtype=complex)
    sx = np.array([[0, 1], [1, 0]], dtype=complex)
    H = gt.hamiltonian(-0.5 * sz, (sx, eps))
    return ([gt.Trajectory([1, 0], H, target_state=[0, 1])],
            np.linspace(0, 5, 501))


@pytest.mark.parametrize("gradient_method", ["gradgen", "taylor"])
def test_tls_with_cheby(gradient_method):
    trajs, tlist = _tls()
    kw = dict(iter_stop=5, J_T=J_T_sm, gradient_method=gradient_method,
              device="cpu", rethrow_exceptions=True, print_iters=False)
    res = gt.optimize(trajs, tlist, prop_method="cheby", **kw)
    assert res.J_T < 1e-3
    assert 0.75 < np.max(np.abs(res.optimized_controls[0])) < 0.85
    res_exp = gt.optimize(trajs, tlist, prop_method="expprop", **kw)
    assert abs(res.J_T - res_exp.J_T) < 1e-6


def test_cnot_cheby_golden_trace():
    """dim 4, 1000 steps, 6 controls, 15 iterations under the Chebyshev
    propagator with the per-step extended-state gradgen pass: the golden
    J_T series recorded from the reference."""
    with open(GOLDEN) as f:
        ref = json.load(f)["cnot_cheby"]
    trace = []
    res = gt.optimize_problem(
        cnot_problem(iter_stop=15), device="cpu", print_iters=False,
        rethrow_exceptions=True,
        callback=lambda wrk, it: trace.append(float(wrk.result.J_T)),
    )
    assert len(trace) == len(ref["J_T_trace"])
    np.testing.assert_allclose(trace, ref["J_T_trace"], rtol=1e-3,
                               atol=1e-10)
    assert res.iter == ref["iter"] and res.converged == ref["converged"]


def test_envelope_growth_rebuilds_tables():
    """A pulse past the envelope bucket grows the bucket, which builds the
    Chebyshev tables again; J is then the reference's at that pulse, where
    the tables of the first bucket no longer cover the spectrum."""
    problem = gt.models.two_transmon_cz_problem(d=4, n_steps=30, T=5.0)
    kwargs = dict(problem.kwargs, prop_method="cheby",
                  gradient_method="taylor", device="cpu")
    wrk = GrapeWrk(problem.trajectories, problem.tlist, kwargs)
    assert port_fg.uses_static_envelope(wrk.cp)
    bucket0 = wrk._amp_bucket
    x = 40.0 * np.asarray(bucket0).max() * np.ones(wrk.n)
    J_stale, _, _ = build_fg(wrk.cp, amp_max=np.asarray(bucket0))(x)
    J, G = wrk.evaluate_gradient(x)
    assert wrk._amp_bucket != bucket0
    assert len(wrk._program_cache) == 2
    ref_problem = ref_cz_problem(d=4, n_steps=30, T=5.0)
    ref_kwargs = dict(ref_problem.kwargs, prop_method="cheby",
                      gradient_method="taylor")
    ref_wrk = RefGrapeWrk(ref_problem.trajectories, ref_problem.tlist,
                          ref_kwargs)
    J_r, G_r = ref_wrk.evaluate_gradient(x)
    assert abs(J - J_r) < 1e-12
    assert np.max(np.abs(G - G_r)) < 1e-10 * np.max(np.abs(G_r))
    J_b, _, _ = ref_fg.build_fg(ref_wrk.cp, amp_max=np.asarray(
        wrk._amp_bucket))(x)
    assert abs(J - float(J_b)) < 1e-12
    # past its spectral interval the old series loses accuracy (here from
    # 1e-16 to about 1e-6)
    assert not abs(float(J_stale) - J) < 1e-8
