"""grape_tpu_torch.functionals against grape_tpu.functionals on the same
seeded states (complex128, to 1e-12: the formulas are a handful of sums),
the Wirtinger convention of ``make_chi`` on ``torch.autograd``, and the
gate and ensemble-gate functionals with their co-states."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import grape_tpu.functionals as ref
import grape_tpu_torch.functionals as port
from grape_tpu.trajectory import Trajectory as RefTrajectory
from grape_tpu_torch.trajectory import Trajectory

torch.set_num_threads(1)

K, D = 3, 5


def _states(seed=0):
    rng = np.random.default_rng(seed)
    psi = rng.normal(size=(K, D)) + 1j * rng.normal(size=(K, D))
    tgt = rng.normal(size=(K, D)) + 1j * rng.normal(size=(K, D))
    psi /= np.linalg.norm(psi, axis=1, keepdims=True)
    tgt /= np.linalg.norm(tgt, axis=1, keepdims=True)
    w = np.array([1.0, 0.5, 2.0])
    return psi, tgt, w


def _trajs(cls, tgt, w):
    return [
        cls(np.zeros(D, dtype=complex), None, target_state=tgt[k],
            weight=w[k])
        for k in range(K)
    ]


NAMES = ["sm", "re", "ss"]


@pytest.mark.parametrize("name", NAMES)
def test_J_T_and_F_match_reference(name):
    psi, tgt, w = _states(1)
    rt, pt = _trajs(RefTrajectory, tgt, w), _trajs(Trajectory, tgt, w)
    P = torch.from_numpy(psi)
    for prefix in ("J_T_", "F_"):
        want = float(getattr(ref, prefix + name)(jnp.asarray(psi), rt))
        got = float(getattr(port, prefix + name)(P, pt))
        assert abs(got - want) < 1e-12
    # the tau protocol gives the same value
    tau = port.taus(P, pt)
    np.testing.assert_allclose(
        tau.numpy(), np.asarray(ref.taus(jnp.asarray(psi), rt)), atol=1e-12
    )
    got_tau = float(getattr(port, "J_T_" + name)(P, pt, tau=tau))
    assert abs(got_tau - float(getattr(port, "J_T_" + name)(P, pt))) < 1e-15


@pytest.mark.parametrize("name", NAMES)
def test_analytic_chi_matches_reference(name):
    psi, tgt, w = _states(2)
    rt, pt = _trajs(RefTrajectory, tgt, w), _trajs(Trajectory, tgt, w)
    want = np.asarray(getattr(ref, "chi_" + name)(jnp.asarray(psi), rt))
    got = getattr(port, "chi_" + name)(torch.from_numpy(psi), pt).numpy()
    assert np.max(np.abs(got - want)) < 1e-12


@pytest.mark.parametrize("name", NAMES)
def test_make_chi_autograd_matches_analytic_and_reference(name):
    """Wirtinger convention: torch's ``.grad`` of a real function of a
    complex tensor is ∂J/∂Re + i ∂J/∂Im, so χ = -½ grad with NO conj
    (``jax.grad`` gives the conjugate, hence the reference's conj)."""
    psi, tgt, w = _states(3)
    rt, pt = _trajs(RefTrajectory, tgt, w), _trajs(Trajectory, tgt, w)
    P = torch.from_numpy(psi)
    J_T = getattr(port, "J_T_" + name)
    assert port.make_chi(J_T, pt) is getattr(port, "chi_" + name)
    chi_ad = port.make_chi(J_T, pt, mode="automatic")(P, pt)
    chi_an = getattr(port, "chi_" + name)(P, pt)
    assert float((chi_ad - chi_an).abs().max()) < 1e-12
    ref_ad = ref.make_chi(getattr(ref, "J_T_" + name), rt, mode="automatic")
    want = np.asarray(ref_ad(jnp.asarray(psi), rt))
    assert np.max(np.abs(chi_ad.numpy() - want)) < 1e-12
    assert not P.requires_grad  # the caller's tensor is left alone


def test_make_chi_on_a_non_analytic_functional():
    """A J_T that is not holomorphic in any sense (mixes Ψ, Ψ* and |Ψ|⁴):
    the autograd χ equals the jax.grad χ of the same formula, and equals
    -∂J/∂Ψ* by finite differences."""
    psi, tgt, w = _states(4)
    rt, pt = _trajs(RefTrajectory, tgt, w), _trajs(Trajectory, tgt, w)

    def J_ref(Psi, trajectories):
        tau = ref.taus(Psi, trajectories)
        return (
            jnp.sum(jnp.abs(Psi) ** 4)
            + jnp.real(jnp.sum(tau * tau)) - jnp.imag(jnp.sum(Psi[0] ** 3))
        )

    def J_port(Psi, trajectories):
        tau = port.taus(Psi, trajectories)
        return (
            torch.sum(torch.abs(Psi) ** 4)
            + torch.real(torch.sum(tau * tau))
            - torch.imag(torch.sum(Psi[0] ** 3))
        )

    P = torch.from_numpy(psi)
    got = port.make_chi(J_port, pt)(P, pt).numpy()
    want = np.asarray(ref.make_chi(J_ref, rt)(jnp.asarray(psi), rt))
    assert np.max(np.abs(got - want)) < 1e-12
    # -dJ/dΨ* = -½ (∂/∂Re + i ∂/∂Im) by central differences on one entry
    h = 1e-6
    for (k, j) in [(0, 1), (2, 3)]:
        def J_at(delta):
            Q = psi.copy()
            Q[k, j] += delta
            return float(J_port(torch.from_numpy(Q), pt))
        d_re = (J_at(h) - J_at(-h)) / (2 * h)
        d_im = (J_at(1j * h) - J_at(-1j * h)) / (2 * h)
        assert abs(got[k, j] - (-0.5) * (d_re + 1j * d_im)) < 1e-7


def test_fluence_and_its_gradient():
    rng = np.random.default_rng(5)
    tlist = np.linspace(0, 3.0, 13)
    eps = rng.normal(size=2 * 12)
    want = float(ref.J_a_fluence(jnp.asarray(eps), tlist))
    got = float(port.J_a_fluence(torch.from_numpy(eps), tlist))
    assert abs(got - want) < 1e-12
    g_want = np.asarray(ref.grad_J_a_fluence(jnp.asarray(eps), tlist))
    g_got = port.grad_J_a_fluence(torch.from_numpy(eps), tlist).numpy()
    assert np.max(np.abs(g_got - g_want)) < 1e-12
    assert port.make_grad_J_a(port.J_a_fluence, tlist) is port.grad_J_a_fluence
    # autograd of a custom running cost
    g_ad = port.make_grad_J_a(
        lambda p, tl: port.J_a_fluence(p, tl) * 1.0, tlist
    )(torch.from_numpy(eps), tlist).numpy()
    assert np.max(np.abs(g_ad - g_want)) < 1e-12


def test_accepts_tau():
    assert port.accepts_tau(port.J_T_sm)
    assert not port.accepts_tau(lambda Psi, trajectories: 0.0)


# --------------------------------------------------------------------------
# Gate and ensemble-gate functionals
# --------------------------------------------------------------------------

N_BASIS, N_SAMPLES = 2, 3


def _ensemble_states(seed):
    """S samples x n_basis states with per-sample weights (constant within
    a sample), for both packages."""
    rng = np.random.default_rng(seed)
    Kt = N_BASIS * N_SAMPLES
    psi = rng.normal(size=(Kt, D)) + 1j * rng.normal(size=(Kt, D))
    tgt = rng.normal(size=(Kt, D)) + 1j * rng.normal(size=(Kt, D))
    psi /= np.linalg.norm(psi, axis=1, keepdims=True)
    tgt /= np.linalg.norm(tgt, axis=1, keepdims=True)
    w = np.repeat([1.0, 0.5, 2.0], N_BASIS)
    mk = lambda cls: [
        cls(np.zeros(D, dtype=complex), None, target_state=tgt[k],
            weight=w[k])
        for k in range(Kt)
    ]
    return psi, mk(RefTrajectory), mk(Trajectory)


def test_ensemble_gate_functional_matches_reference():
    psi, rt, pt = _ensemble_states(6)
    J_ref = ref.make_ensemble_gate_functional(N_BASIS)
    J_port = port.make_ensemble_gate_functional(N_BASIS)
    P = torch.from_numpy(psi)
    want = float(J_ref(jnp.asarray(psi), rt))
    assert abs(float(J_port(P, pt)) - want) < 1e-12
    assert abs(float(J_port(P, pt, tau=port.taus(P, pt))) - want) < 1e-12
    # coherent within a sample, incoherent across: a global phase per
    # sample leaves it unchanged, unlike J_T_sm over all trajectories
    phases = np.repeat(np.exp(1j * np.array([0.3, 1.1, -2.0])), N_BASIS)
    Q = torch.from_numpy(psi * phases[:, None])
    assert abs(float(J_port(Q, pt)) - want) < 1e-12
    assert abs(float(port.J_T_sm(Q, pt)) - float(port.J_T_sm(P, pt))) > 1e-3
    assert port.accepts_tau(J_port)
    with pytest.raises(ValueError, match="multiple"):
        port.make_ensemble_gate_functional(4)(P, pt)


def test_ensemble_gate_chi_matches_reference_and_finite_differences():
    """The co-state of the ensemble functional comes from ``make_chi``
    semi-AD in both packages."""
    psi, rt, pt = _ensemble_states(7)
    J_port = port.make_ensemble_gate_functional(N_BASIS)
    chi = port.make_chi(J_port, pt)(torch.from_numpy(psi), pt).numpy()
    J_ref = ref.make_ensemble_gate_functional(N_BASIS)
    want = np.asarray(ref.make_chi(J_ref, rt)(jnp.asarray(psi), rt))
    assert np.max(np.abs(chi - want)) < 1e-12
    h = 1e-6
    for (k, j) in [(0, 1), (3, 2), (5, 4)]:
        def J_at(delta):
            Q = psi.copy()
            Q[k, j] += delta
            return float(J_port(torch.from_numpy(Q), pt))
        d_re = (J_at(h) - J_at(-h)) / (2 * h)
        d_im = (J_at(1j * h) - J_at(-1j * h)) / (2 * h)
        assert abs(chi[k, j] - (-0.5) * (d_re + 1j * d_im)) < 1e-7


def _gate_setup(seed):
    """K = 3 basis states in D = 5 dimensions and a target gate O."""
    rng = np.random.default_rng(seed)
    basis = np.linalg.qr(
        rng.normal(size=(D, D)) + 1j * rng.normal(size=(D, D))
    )[0][:, :K].T  # (K, D), orthonormal rows
    psi = rng.normal(size=(K, D)) + 1j * rng.normal(size=(K, D))
    psi /= np.linalg.norm(psi, axis=1, keepdims=True)
    O = np.linalg.qr(
        rng.normal(size=(K, K)) + 1j * rng.normal(size=(K, K))
    )[0]
    mk = lambda cls: [cls(basis[k], None, target_state=basis[k])
                      for k in range(K)]
    return basis, psi, O, mk(RefTrajectory), mk(Trajectory)


def test_gate_functional_and_gate_chi():
    """``J(U_L) = 1 - |tr(O^dagger U_L)|^2 / K^2 + sum |U_L|^4`` lifted by
    ``gate_functional``: the value and ``make_gate_chi``'s co-state against
    the reference (which conjugates ``jax.grad``'s result where the port
    must not) and against finite differences of the lifted functional."""
    basis, psi, O, rt, pt = _gate_setup(8)

    def J_U_ref(U, O):
        return (1.0 - jnp.abs(jnp.sum(jnp.conj(O) * U)) ** 2 / K**2
                + 0.1 * jnp.sum(jnp.abs(U) ** 4))

    def J_U_port(U, O):
        return (1.0 - torch.abs(torch.sum(torch.conj(O) * U)) ** 2 / K**2
                + 0.1 * torch.sum(torch.abs(U) ** 4))

    P = torch.from_numpy(psi)
    O_t = torch.from_numpy(O)
    J_ref = ref.gate_functional(J_U_ref, O=jnp.asarray(O))
    J_port = port.gate_functional(J_U_port, O=O_t)
    want = float(J_ref(jnp.asarray(psi), rt))
    assert abs(float(J_port(P, pt)) - want) < 1e-12
    # (U_L)_ij = <phi_i | Psi_j>
    U_L = np.conj(basis) @ psi.T
    assert abs(float(J_U_port(torch.from_numpy(U_L), O_t)) - want) < 1e-12

    chi = port.make_gate_chi(J_U_port, pt, O=O_t)(P, pt).numpy()
    chi_ref = np.asarray(
        ref.make_gate_chi(J_U_ref, rt, O=jnp.asarray(O))(jnp.asarray(psi), rt)
    )
    assert chi.shape == (K, D)
    assert np.max(np.abs(chi - chi_ref)) < 1e-12
    assert not P.requires_grad
    # the chain rule agrees with semi-AD of the lifted functional where Psi
    # lies in the span of the basis (chi only has components there)
    coef = np.random.default_rng(9).normal(size=(K, K)) + 0j
    psi_in = coef @ basis
    P_in = torch.from_numpy(psi_in)
    chi_in = port.make_gate_chi(J_U_port, pt, O=O_t)(P_in, pt).numpy()
    chi_ad = port.make_chi(J_port, pt, mode="automatic")(P_in, pt).numpy()
    assert np.max(np.abs(chi_in - chi_ad)) < 1e-12
    h = 1e-6
    for (k, j) in [(0, 0), (1, 3), (2, 4)]:
        def J_at(delta):
            Q = psi_in.copy()
            Q[k, j] += delta
            return float(J_port(torch.from_numpy(Q), pt))
        d_re = (J_at(h) - J_at(-h)) / (2 * h)
        d_im = (J_at(1j * h) - J_at(-1j * h)) / (2 * h)
        assert abs(chi_in[k, j] - (-0.5) * (d_re + 1j * d_im)) < 1e-7
