"""Open-system (Lindblad) model family.

Density matrices are vectorized states to the GRAPE engine: the
Liouvillian from :func:`grape_tpu_torch.generators.liouvillian` propagates
``vec(ρ)`` with the same machinery.  Its generators are neither Hermitian
nor normal, and nothing on the port's paths assumes either: the propagator
kernels exponentiate ``-i dt L`` as given, the co-state chains apply
``U†`` explicitly, and the Fréchet and Taylor passes take ``L†`` where the
adjoint is needed.
"""

import numpy as np

from ..functionals import J_T_re
from ..generators import hamiltonian, liouvillian
from ..shapes import flattop
from ..trajectory import ControlProblem, Trajectory

__all__ = ["dissipative_tls_problem"]


def _vec(rho):
    """Column-stacking vectorization matching ``liouvillian`` (vec(ρ) with
    ``dvec(ρ)/dt = -i L vec(ρ)``)."""
    return np.asarray(rho, dtype=complex).T.reshape(-1)


def dissipative_tls_problem(gamma=0.05, Omega=1.0, T=5.0, n_steps=500,
                            E0=0.2, **kwargs):
    """Dissipative two-level state transfer ρ(0)=|0⟩⟨0| → |1⟩⟨1| under
    amplitude damping at rate ``gamma`` (decay |1⟩→|0⟩).

    The optimizer must beat the decay: fast transfer late in the window.
    ``J_T_re`` on vectorized density matrices is ``1 - Re tr(ρ_tgt†ρ(T))``
    = 1 - P₁(T) for this pure target."""
    sz = np.array([[1, 0], [0, -1]], dtype=complex)
    sx = np.array([[0, 1], [1, 0]], dtype=complex)
    sm = np.array([[0, 1], [0, 0]], dtype=complex)

    def eps(t):
        return E0 * float(flattop(t, T=T, t_rise=0.3, func="blackman"))

    H = hamiltonian(-0.5 * Omega * sz, (sx, eps))
    L = liouvillian(H, c_ops=[np.sqrt(gamma) * sm])
    tlist = np.linspace(0, T, n_steps + 1)
    rho0 = np.diag([1.0, 0.0]).astype(complex)
    rho1 = np.diag([0.0, 1.0]).astype(complex)
    traj = Trajectory(_vec(rho0), L, target_state=_vec(rho1))
    kwargs.setdefault("J_T", J_T_re)
    return ControlProblem([traj], tlist, **kwargs)
