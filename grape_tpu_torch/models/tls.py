"""The canonical two-level-system problems.

The reference's README / tutorial model: ``H = -Ω/2 σ_z + ε(t) σ_x``,
|0⟩→|1⟩ state transfer over T=5 with 500 steps, guess pulse
``0.2·flattop``; and the X-gate over four basis states with a fluence
running cost (BASELINE config 2).
"""

import numpy as np

from ..functionals import J_T_sm, J_a_fluence
from ..generators import hamiltonian
from ..shapes import flattop
from ..trajectory import ControlProblem, Trajectory

__all__ = ["tls_problem", "tls_xgate_problem"]


def tls_problem(Omega=1.0, T=5.0, n_steps=500, E0=0.2, t_rise=0.3, **kwargs):
    def eps(t):
        return E0 * float(flattop(t, T=T, t_rise=t_rise, func="blackman"))

    sz = np.array([[1, 0], [0, -1]], dtype=complex)
    sx = np.array([[0, 1], [1, 0]], dtype=complex)
    H = hamiltonian(-0.5 * Omega * sz, (sx, eps))
    tlist = np.linspace(0, T, n_steps + 1)
    traj = Trajectory([1, 0], H, target_state=[0, 1])
    return ControlProblem([traj], tlist, **kwargs)


def tls_xgate_problem(Omega=1.0, T=5.0, n_steps=500, E0=0.2,
                      lambda_a=1e-4, **kwargs):
    """TLS X-gate with 4 basis trajectories and a pulse running cost
    (BASELINE config 2).

    ``H = -Ω/2 σ_z + ε_x(t) σ_x + ε_y(t) σ_y``; the trajectory set
    {|0⟩, |1⟩, |+⟩, |+i⟩} → X·ψ is tomography-complete, so the
    global-phase-invariant ``J_T_sm`` is a faithful gate infidelity
    (two basis states alone leave a relative-phase blind spot).  A
    fluence running cost ``λ_a·J_a`` regularizes the pulses."""
    def eps_x(t):
        return E0 * float(flattop(t, T=T, t_rise=0.3, func="blackman"))

    def eps_y(t):
        return 0.0

    sx = np.array([[0, 1], [1, 0]], dtype=complex)
    sy = np.array([[0, -1j], [1j, 0]], dtype=complex)
    sz = np.array([[1, 0], [0, -1]], dtype=complex)
    H = hamiltonian(-0.5 * Omega * sz, (sx, eps_x), (sy, eps_y))
    tlist = np.linspace(0, T, n_steps + 1)
    s2 = 1.0 / np.sqrt(2.0)
    basis = [
        np.array([1, 0], dtype=complex),
        np.array([0, 1], dtype=complex),
        np.array([s2, s2], dtype=complex),
        np.array([s2, 1j * s2], dtype=complex),
    ]
    trajectories = [
        Trajectory(psi, H, target_state=sx @ psi) for psi in basis
    ]
    kwargs.setdefault("J_T", J_T_sm)
    kwargs.setdefault("J_a", J_a_fluence)
    kwargs.setdefault("lambda_a", lambda_a)
    return ControlProblem(trajectories, tlist, **kwargs)
