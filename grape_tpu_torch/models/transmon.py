"""Transmon model family: the single-transmon qutrit gate with a
guard-level running cost (BASELINE config 3), the two-transmon CZ gate with
multi-control pulses (BASELINE config 4), the flagship of the
gate-optimization path,
unitary synthesis on a subspace of the same register (many basis states
under one generator), and robust ensembles over Hamiltonian samples
(BASELINE config 5)."""

import numpy as np
import torch

from ..functionals import J_T_sm, make_ensemble_gate_functional
from ..generators import hamiltonian
from ..shapes import flattop
from ..trajectory import ControlProblem, Trajectory

__all__ = [
    "transmon_qutrit_problem", "two_transmon_cz_problem", "two_transmon_subspace_gate_problem",
    "two_transmon_cz_ensemble_problem", "transmon_ensemble_trajectories",
]


def _ladder(d):
    a = np.diag(np.sqrt(np.arange(1, d)), 1).astype(complex)
    n = np.diag(np.arange(d)).astype(complex)
    return a, n


def transmon_qutrit_problem(
    d=3, delta=0.0, alpha=-0.3 * 2 * np.pi, T=20.0, n_steps=400,
    E0=0.05, lambda_b=1.0, **kwargs
):
    """Single-transmon X-gate on the qubit subspace with a running-cost
    penalty on the guard (|2⟩+) levels (BASELINE config 3): ``g_b`` is the
    guard population, ``ξ = -P_guard·Ψ`` its analytic co-state source."""
    a, n = _ladder(d)
    H0 = delta * n + 0.5 * alpha * (n @ n - n)
    Hx = 0.5 * (a + a.conj().T)
    Hy = 0.5j * (a - a.conj().T)

    def guess_x(t):
        return E0 * float(flattop(t, T=T, t_rise=2.0, func="blackman"))

    def guess_y(t):
        return 0.0

    H = hamiltonian(H0, (Hx, guess_x), (Hy, guess_y))
    tlist = np.linspace(0, T, n_steps + 1)

    # X gate on the qubit subspace; guard level maps to itself
    e = np.eye(d, dtype=complex)
    targets = {0: e[1], 1: e[0]}
    trajectories = [
        Trajectory(e[k], H, target_state=targets[k]) for k in (0, 1)
    ]

    def g_b(Psi, trajectories, tl, nn):
        # population of the guard levels (index >= 2)
        return torch.sum(torch.abs(Psi[..., 2:]) ** 2, dim=-1)

    def xi(Psi, trajectories, tl, nn):
        out = torch.zeros_like(Psi)
        out[..., 2:] = -Psi[..., 2:]
        return out

    kwargs.setdefault("J_T", J_T_sm)
    return ControlProblem(
        trajectories, tlist, g_b=g_b, xi=xi, lambda_b=lambda_b, **kwargs
    )


def _two_transmon_hamiltonian(d, delta1, delta2, alpha1, alpha2, J):
    a, n = _ladder(d)
    I = np.eye(d, dtype=complex)
    a1 = np.kron(a, I)
    a2 = np.kron(I, a)
    n1 = np.kron(n, I)
    n2 = np.kron(I, n)
    H0 = (
        delta1 * n1 + 0.5 * alpha1 * (n1 @ n1 - n1)
        + delta2 * n2 + 0.5 * alpha2 * (n2 @ n2 - n2)
        + J * (a1 @ a2.conj().T + a1.conj().T @ a2)
    )
    drives = [
        0.5 * (a1 + a1.conj().T), 0.5j * (a1 - a1.conj().T),
        0.5 * (a2 + a2.conj().T), 0.5j * (a2 - a2.conj().T),
    ]
    return H0, drives


def two_transmon_cz_problem(
    d=10, delta1=0.0, delta2=0.5, alpha1=-1.2, alpha2=-1.0, J=0.05,
    T=50.0, n_steps=2000, E0=0.05, guesses=None, **kwargs
):
    """Two-transmon CZ gate in the full bipartite space (dim = d², i.e.
    100 for d=10 — BASELINE config 4), 4 drive controls, 2000 steps.

    The logical CZ is defined on the 2x2 qubit subspace; trajectories are
    the four logical basis states.
    """
    H0, drives = _two_transmon_hamiltonian(
        d, delta1, delta2, alpha1, alpha2, J
    )
    tlist = np.linspace(0, T, n_steps + 1)
    if guesses is None:
        def mk_guess(scale, phase):
            def g(t):
                return scale * float(
                    flattop(t, T=T, t_rise=5.0, func="blackman")
                )
            return g

        guesses = [mk_guess(E0, 0), mk_guess(0.0, 0),
                   mk_guess(E0, 0), mk_guess(0.0, 0)]
    H = hamiltonian(H0, *zip(drives, guesses))

    dim = d * d

    def logical(i, j):
        v = np.zeros(dim, dtype=complex)
        v[i * d + j] = 1.0
        return v

    basis = [logical(0, 0), logical(0, 1), logical(1, 0), logical(1, 1)]
    cz_phases = [1.0, 1.0, 1.0, -1.0]
    trajectories = [
        Trajectory(b, H, target_state=ph * b)
        for b, ph in zip(basis, cz_phases)
    ]
    kwargs.setdefault("J_T", J_T_sm)
    return ControlProblem(trajectories, tlist, **kwargs)


def two_transmon_subspace_gate_problem(
    d=32, n_basis=64, delta1=0.0, delta2=0.5, alpha1=-1.2, alpha2=-1.0,
    J=0.05, T=1.0, n_steps=100, E0=0.05, seed=0, **kwargs
):
    """Unitary synthesis on an ``n_basis``-dimensional subspace of the
    two-transmon register (dim = d²): K = n_basis computational basis
    states propagate under ONE shared generator toward a seeded random
    target unitary on the subspace (the reference's gate-functional
    pattern with many basis states: the forward product is one
    ``(K, dim) @ (dim, dim)`` product per propagator term)."""
    H0, drives = _two_transmon_hamiltonian(
        d, delta1, delta2, alpha1, alpha2, J
    )
    dim = d * d
    if not (1 <= n_basis <= dim):
        raise ValueError(f"n_basis must be in [1, {dim}]")
    tlist = np.linspace(0, T, n_steps + 1)

    def mk_guess(scale):
        def g(t):
            return scale * float(
                flattop(t, T=T, t_rise=T / 10.0, func="blackman")
            )
        return g

    guesses = [mk_guess(E0), mk_guess(0.0), mk_guess(E0), mk_guess(0.0)]
    H = hamiltonian(H0, *zip(drives, guesses))

    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n_basis, n_basis)) \
        + 1j * rng.normal(size=(n_basis, n_basis))
    W, _ = np.linalg.qr(A)  # Haar-like target unitary on the subspace
    basis = np.eye(dim, dtype=complex)[:, :n_basis]
    targets = basis @ W  # (dim, n_basis) target states
    trajectories = [
        Trajectory(basis[:, i], H, target_state=targets[:, i])
        for i in range(n_basis)
    ]
    kwargs.setdefault("J_T", J_T_sm)
    return ControlProblem(trajectories, tlist, **kwargs)


def two_transmon_cz_ensemble_problem(
    n_samples=8, d=10, delta_spread=0.02, delta1=0.0, delta2=0.5,
    alpha1=-1.2, alpha2=-1.0, J=0.05, T=50.0, n_steps=2000, E0=0.05,
    seed=0, **kwargs
):
    """Robust two-transmon CZ (BASELINE config 5): an ensemble of
    ``n_samples`` perturbed Hamiltonians — per-sample detunings drawn from
    ``±delta_spread`` — each propagating the 4 logical basis states, so
    ``K = 4·n_samples`` trajectories in ``n_samples`` generator groups of 4
    (each sample's trajectories hold the SAME generator object), sharing
    one set of 4 drive controls."""
    rng = np.random.default_rng(seed)
    tlist = np.linspace(0, T, n_steps + 1)

    def mk_guess(scale):
        def g(t):
            return scale * float(
                flattop(t, T=T, t_rise=min(5.0, T / 10.0), func="blackman")
            )
        return g

    guesses = [mk_guess(E0), mk_guess(0.0), mk_guess(E0), mk_guess(0.0)]

    dim = d * d

    def logical(i, j):
        v = np.zeros(dim, dtype=complex)
        v[i * d + j] = 1.0
        return v

    basis = [logical(0, 0), logical(0, 1), logical(1, 0), logical(1, 1)]
    cz_phases = [1.0, 1.0, 1.0, -1.0]
    trajectories = []
    for _ in range(n_samples):
        d1 = delta1 + rng.uniform(-delta_spread, delta_spread)
        d2 = delta2 + rng.uniform(-delta_spread, delta_spread)
        H0, drives = _two_transmon_hamiltonian(
            d, d1, d2, alpha1, alpha2, J
        )
        # the SAME guess callables across samples: one shared control set
        H = hamiltonian(H0, *zip(drives, guesses))
        for b, ph in zip(basis, cz_phases):
            trajectories.append(Trajectory(b, H, target_state=ph * b))
    # per-sample-coherent, cross-sample-incoherent gate functional: a
    # global J_T_sm would sum tau coherently across samples, where the
    # sample-dependent drift phases interfere destructively
    kwargs.setdefault("J_T", make_ensemble_gate_functional(4))
    return ControlProblem(trajectories, tlist, **kwargs)


def transmon_ensemble_trajectories(
    n_samples, d=3, delta_spread=0.02, alpha=-0.3 * 2 * np.pi,
    T=20.0, E0=0.05, seed=0,
):
    """Robust-ensemble trajectories: `n_samples` Hamiltonian samples with
    detuning drawn from ``±delta_spread`` (BASELINE config 5 pattern), all
    sharing one set of controls."""
    rng = np.random.default_rng(seed)
    a, n = _ladder(d)
    Hx = 0.5 * (a + a.conj().T)
    Hy = 0.5j * (a - a.conj().T)

    def guess_x(t):
        return E0 * float(flattop(t, T=T, t_rise=2.0, func="blackman"))

    def guess_y(t):
        return 0.0

    e = np.eye(d, dtype=complex)
    deltas = rng.uniform(-delta_spread, delta_spread, n_samples)
    trajectories = []
    for k in range(n_samples):
        H0 = deltas[k] * n + 0.5 * alpha * (n @ n - n)
        H = hamiltonian(H0, (Hx, guess_x), (Hy, guess_y))
        trajectories.append(
            Trajectory(e[0], H, target_state=e[1], weight=1.0)
        )
    return trajectories
