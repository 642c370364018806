"""Transmon model family: the two-transmon CZ gate with multi-control
pulses (BASELINE config 4), the flagship of the gate-optimization path."""

import numpy as np

from ..functionals import J_T_sm
from ..generators import hamiltonian
from ..shapes import flattop
from ..trajectory import ControlProblem, Trajectory

__all__ = ["two_transmon_cz_problem"]


def _ladder(d):
    a = np.diag(np.sqrt(np.arange(1, d)), 1).astype(complex)
    n = np.diag(np.arange(d)).astype(complex)
    return a, n


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
