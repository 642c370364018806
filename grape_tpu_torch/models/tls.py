"""The canonical two-level-system benchmark problem.

The reference's README / tutorial model: ``H = -Ω/2 σ_z + ε(t) σ_x``,
|0⟩→|1⟩ state transfer over T=5 with 500 steps, guess pulse
``0.2·flattop``.
"""

import numpy as np

from ..generators import hamiltonian
from ..shapes import flattop
from ..trajectory import ControlProblem, Trajectory

__all__ = ["tls_problem"]


def tls_problem(Omega=1.0, T=5.0, n_steps=500, E0=0.2, t_rise=0.3, **kwargs):
    def eps(t):
        return E0 * float(flattop(t, T=T, t_rise=t_rise, func="blackman"))

    sz = np.array([[1, 0], [0, -1]], dtype=complex)
    sx = np.array([[0, 1], [1, 0]], dtype=complex)
    H = hamiltonian(-0.5 * Omega * sz, (sx, eps))
    tlist = np.linspace(0, T, n_steps + 1)
    traj = Trajectory([1, 0], H, target_state=[0, 1])
    return ControlProblem([traj], tlist, **kwargs)
