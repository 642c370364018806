"""The open system through ``grape_tpu_torch``: ``liouvillian``,
``models.dissipative_tls_problem`` and ``models.tls_xgate_problem``
against ``grape_tpu`` on the same numpy inputs, and the kernels' plain
versions on non-Hermitian generators.

Tolerances: the Liouvillian bit for bit (the same numpy algebra); against
the Lindblad master equation integrated by scipy 1e-6 (the reference's own
test) and against ``scipy.linalg.expm`` of the same Liouvillian 1e-12;
complex128 ``fg`` J to 1e-12 and the gradient to 1e-10 of its largest
entry (the port's usual tolerances); the plain versions of the kernels in
complex64 against a complex128 evaluation by scipy 2e-5 of the scale
(float32 arithmetic over a few steps), and the complex64 ``fg`` against
complex128 J 1e-5, gradient 2e-3 of its largest entry (float32 over the
whole grid, the tolerances of the kernel-vs-plain checks).
"""

import numpy as np
import pytest
import scipy.linalg
import torch

from grape_tpu import generators as ref_generators
from grape_tpu.fg import build_fg as ref_build_fg
from grape_tpu.fg import compile_problem as ref_compile_problem
from grape_tpu.models import dissipative_tls_problem as ref_dissipative
from grape_tpu.models import tls_xgate_problem as ref_xgate

import grape_tpu_torch as gt
from grape_tpu_torch import build_fg, compile_problem
from grape_tpu_torch import compiled_problem_from_numpy
from grape_tpu_torch.models import dissipative_tls_problem, tls_xgate_problem
from grape_tpu_torch.ops import hopper_frechet, hopper_prop

from tests.test_torch_fg import _arrays_of

torch.set_num_threads(1)

SZ = np.array([[1, 0], [0, -1]], dtype=complex)
SX = np.array([[0, 1], [1, 0]], dtype=complex)
SM = np.array([[0, 1], [0, 0]], dtype=complex)  # decay |1> -> |0>


def _eps(t):
    return 0.2 * np.sin(0.7 * t)


@pytest.mark.parametrize("form", ["generator", "matrix"])
def test_liouvillian_matches_reference(form):
    rng = np.random.default_rng(5)
    d = 3
    H0 = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    H0 = H0 + H0.conj().T
    H1 = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    c_ops = [rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
             for _ in range(2)]
    if form == "generator":
        L = gt.liouvillian(gt.hamiltonian(H0, (H1, _eps)), c_ops=c_ops)
        L_ref = ref_generators.liouvillian(
            ref_generators.hamiltonian(H0, (H1, _eps)), c_ops=c_ops)
    else:
        L = gt.liouvillian(H0, c_ops=c_ops)
        L_ref = ref_generators.liouvillian(H0, c_ops=c_ops)
    assert np.array_equal(L.drift, L_ref.drift)
    assert len(L.terms) == len(L_ref.terms)
    for (op, amp), (op_ref, amp_ref) in zip(L.terms, L_ref.terms):
        assert np.array_equal(op, op_ref) and amp is amp_ref
    # the Liouvillian of a dissipative system is not normal
    A = L.drift
    assert np.abs(A @ A.conj().T - A.conj().T @ A).max() > 1e-3


def test_liouvillian_matches_master_equation():
    """exp(-i L t) on vec(ρ) reproduces the Lindblad solution, through
    ``propagate`` and through scipy's exponential of the same matrix."""
    from scipy.integrate import solve_ivp

    H = -0.5 * SZ + 0.3 * SX
    c = np.sqrt(0.4) * SM
    Lgen = gt.liouvillian(gt.hamiltonian(H, (np.zeros((2, 2)), _eps)),
                          c_ops=[c])
    rho0 = np.array([[0, 0], [0, 1]], dtype=complex)
    t = 0.7
    tlist = np.linspace(0, t, 141)
    vec_rho_T = gt.propagate(rho0.T.reshape(-1), Lgen, tlist, device="cpu")
    rho_T = vec_rho_T.reshape(2, 2).T

    def rhs(_, y):
        rho = y.reshape(2, 2)
        drho = -1j * (H @ rho - rho @ H)
        drho += c @ rho @ c.conj().T - 0.5 * (
            c.conj().T @ c @ rho + rho @ c.conj().T @ c)
        return drho.reshape(-1)

    sol = solve_ivp(rhs, (0, t), rho0.reshape(-1).astype(complex),
                    rtol=1e-10, atol=1e-12)
    rho_ref = sol.y[:, -1].reshape(2, 2)
    assert np.linalg.norm(rho_T - rho_ref) < 1e-6
    assert abs(np.trace(rho_T) - 1.0) < 1e-8  # trace preserving
    direct = scipy.linalg.expm(-1j * t * Lgen.drift) @ rho0.T.reshape(-1)
    assert np.abs(vec_rho_T - direct).max() < 1e-12


MODELS = {
    "dissipative_tls": (
        lambda: dissipative_tls_problem(n_steps=50),
        lambda: ref_dissipative(n_steps=50),
        dict(J_T="J_T_re"),
    ),
    "tls_xgate": (
        lambda: tls_xgate_problem(n_steps=50),
        lambda: ref_xgate(n_steps=50),
        dict(J_T="J_T_sm", J_a="J_a_fluence", lambda_a=1e-4),
    ),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_compiles_as_reference(name):
    build, build_ref, _ = MODELS[name]
    p, p_ref = build(), build_ref()
    cp = compile_problem(p.trajectories, p.tlist, device="cpu", **p.kwargs)
    cp_ref = ref_compile_problem(p_ref.trajectories, p_ref.tlist,
                                 **p_ref.kwargs)
    for key in ("psi0", "H0", "ops", "M", "Mfix", "tlist",
                "guess_pulsevals"):
        assert np.array_equal(getattr(cp, key), np.asarray(
            getattr(cp_ref, key))), key
    for key in ("ctl_idx", "shared_generator", "n_controls", "n_traj",
                "dim", "lambda_a"):
        assert getattr(cp, key) == getattr(cp_ref, key), key
    targets = [t.target_state for t in p.trajectories]
    targets_ref = [t.target_state for t in p_ref.trajectories]
    assert np.array_equal(np.stack(targets), np.stack(targets_ref))


@pytest.fixture(scope="module")
def compiled():
    """Per (model, method): the reference's fg and the port's on the
    reference's arrays and from the port's own compile, built once."""
    cache = {}

    def get(name, method):
        if (name, method) not in cache:
            build, build_ref, fns = MODELS[name]
            p, p_ref = build(), build_ref()
            cp_ref = ref_compile_problem(
                p_ref.trajectories, p_ref.tlist, gradient_method=method,
                **p_ref.kwargs)
            cp = compiled_problem_from_numpy(
                _arrays_of(cp_ref), gradient_method=method, device="cpu",
                **fns)
            own = compile_problem(p.trajectories, p.tlist, device="cpu",
                                  gradient_method=method, **p.kwargs)
            cache[name, method] = (cp_ref, ref_build_fg(cp_ref),
                                   build_fg(cp), build_fg(own))
        return cache[name, method]

    return get


@pytest.mark.parametrize("pulse", ["guess", "perturbed"])
@pytest.mark.parametrize("method", ["gradgen", "taylor"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_fg_matches_reference(compiled, name, method, pulse):
    cp_ref, fg_ref, fg, fg_own = compiled(name, method)
    x = np.asarray(cp_ref.guess_pulsevals).reshape(-1)
    if pulse == "perturbed":
        x = x + 0.05 * np.random.default_rng(9).normal(size=x.shape)
    J_ref, g_ref, _ = fg_ref(x)
    g_ref = np.asarray(g_ref)
    for f in (fg, fg_own):
        J, g, aux = f(x)
        assert abs(float(J) - float(J_ref)) < 1e-12
        assert np.max(np.abs(g.numpy() - g_ref)) < 1e-10 * np.max(
            np.abs(g_ref))
        assert bool(aux["taylor_ok"]) and bool(aux["chi_ok"])


def _lindblad_inputs(d, N_T, seed):
    """A random d-level Hamiltonian with two control terms and two decay
    channels, lifted to Liouville space (dimension d²): complex128 numpy
    ``(L0, Lops (2, d², d²), coeffs (N_T, 2), dts (N_T,))``."""
    rng = np.random.default_rng(seed)

    def herm():
        A = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
        return 0.5 * (A + A.conj().T)

    c_ops = [0.3 * np.diag(np.ones(d - 1), 1), 0.2 * np.diag(
        np.arange(d, dtype=float))]
    L = gt.liouvillian(gt.hamiltonian(herm(), (herm(), _eps),
                                      (herm(), _eps)), c_ops=c_ops)
    Lops = np.stack([op for op, _ in L.terms])
    coeffs = 0.4 * rng.normal(size=(N_T, 2))
    dts = 0.05 * (1 + 0.1 * rng.uniform(size=N_T))
    return L.drift, Lops, coeffs, dts


@pytest.mark.parametrize("s", [0, 2])
@pytest.mark.parametrize("d", [2, 3])
def test_kernel_plain_versions_on_liouvillians(d, s):
    """The plain versions that the CUDA kernels are held against on the
    card (forward scan with its propagators, the χ chain, both Fréchet
    algorithms) on non-Hermitian, non-normal generators, against complex128
    evaluations by scipy: ``U_n = exp(A_n)``, ``χ ← U†χ`` and
    ``tr(Op_t L(A_n, ψχ†))`` with ``A_n = −i dt_n (L0 + Σ_t c_t Lop_t)``."""
    N_T, K = 6, 3
    L0, Lops, coeffs, dts = _lindblad_inputs(d, N_T, seed=10 * d + s)
    D = d * d
    rng = np.random.default_rng(s)
    psi0 = rng.normal(size=(K, D)) + 1j * rng.normal(size=(K, D))
    chi0 = rng.normal(size=(K, D)) + 1j * rng.normal(size=(K, D))
    c64 = lambda x: torch.as_tensor(np.ascontiguousarray(x),
                                    dtype=torch.complex64)
    f32 = lambda x: torch.as_tensor(np.ascontiguousarray(x),
                                    dtype=torch.float32)
    # with s squarings the scaled step stays inside the series' range
    dts = dts * 2.0 ** s
    st, U = hopper_prop.forward_scan_shared(
        c64(L0), c64(Lops), f32(coeffs), f32(dts), c64(psi0), s)
    chis = hopper_prop.chi_scan_shared(U, c64(chi0))
    A = [-1j * dts[n] * (L0 + np.einsum("t,tij->ij", coeffs[n], Lops))
         for n in range(N_T)]
    U_ref = np.stack([scipy.linalg.expm(a) for a in A])
    psi = psi0.copy()
    st_ref = [psi]
    for n in range(N_T):
        psi = psi @ U_ref[n].T
        st_ref.append(psi)
    st_ref = np.stack(st_ref)
    chi = chi0.copy()
    chis_ref = np.empty((N_T, K, D), dtype=complex)
    for n in reversed(range(N_T)):
        chis_ref[n] = chi
        chi = chi @ U_ref[n].conj()
    scale = max(np.abs(st_ref).max(), np.abs(chis_ref).max())
    assert np.abs(U.numpy() - U_ref).max() < 2e-5 * np.abs(U_ref).max()
    assert np.abs(st.numpy() - st_ref).max() < 2e-5 * scale
    assert np.abs(chis.numpy() - chis_ref).max() < 2e-5 * scale
    psis = st_ref[:-1]
    trj_ref = np.empty((N_T, K, 2), dtype=complex)
    for n in range(N_T):
        for k in range(K):
            R = np.outer(psis[n, k], chis_ref[n, k].conj())
            _, Lf = scipy.linalg.expm_frechet(A[n], R)
            trj_ref[n, k] = np.einsum("tab,ba->t", Lops, Lf)
    tscale = np.abs(trj_ref).max()
    for route in ("dense", "factored"):
        trj = hopper_frechet._frechet_trace(
            "frechet_trace_shared", c64(L0[None]), c64(Lops[None]),
            f32(coeffs), f32(dts), c64(psis), c64(chis_ref), s, route=route)
        assert np.abs(trj.numpy() - trj_ref).max() < 2e-5 * tscale, route


@pytest.mark.parametrize("method", ["gradgen", "taylor"])
def test_open_system_complex64_against_complex128(method):
    """The dissipative TLS's evaluation through the kernels' plain versions
    in complex64 against the plain complex128 path."""
    p = dissipative_tls_problem(n_steps=60)
    cps = [compile_problem(p.trajectories, p.tlist, device="cpu", dtype=dt,
                           gradient_method=method, **p.kwargs)
           for dt in (np.complex64, np.complex128)]
    x = cps[1].guess_pulsevals.reshape(-1)
    (J32, g32, _), (J64, g64, _) = (build_fg(cp)(x) for cp in cps)
    assert abs(float(J32) - float(J64)) < 1e-5
    g64 = g64.numpy()
    assert np.abs(g32.double().numpy() - g64).max() < 2e-3 * np.abs(
        g64).max()
