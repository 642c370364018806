"""Randomized test fixtures, the counterpart of ``grape_tpu.testing``.

Deterministic seeded random Hamiltonians, states and control problems, and
the small reference problems of the golden traces.  The fixtures draw from
``numpy.random.Generator`` in exactly the reference's order, so the same
seed gives bit-identical matrices, states and pulses in both packages.
"""

import numpy as np

from .generators import hamiltonian
from .trajectory import ControlProblem, Trajectory

__all__ = [
    "random_matrix", "random_state_vector", "dummy_control_problem",
    "tls_problem", "stirap_problem", "cnot_problem",
]


def random_matrix(N, rng=None, hermitian=False):
    rng = rng or np.random.default_rng()
    A = (rng.normal(size=(N, N)) + 1j * rng.normal(size=(N, N))) / np.sqrt(N)
    if hermitian:
        A = 0.5 * (A + A.conj().T)
    return A


def random_state_vector(N, rng=None):
    rng = rng or np.random.default_rng()
    psi = rng.normal(size=N) + 1j * rng.normal(size=N)
    return psi / np.linalg.norm(psi)


def dummy_control_problem(
    N=10,
    n_trajectories=1,
    n_controls=1,
    n_steps=50,
    t_max=1.0,
    rng=None,
    **kwargs,
):
    """Deterministic random control problem: Hermitian drift + `n_controls`
    Hermitian control operators shared across `n_trajectories`, random
    normalized initial/target states, random small guess pulses on the
    interval midpoints."""
    rng = rng or np.random.default_rng(1244538994)
    tlist = np.linspace(0.0, t_max, n_steps + 1)
    H0 = random_matrix(N, rng, hermitian=True)
    Hc = [random_matrix(N, rng, hermitian=True) for _ in range(n_controls)]
    pulses = [rng.normal(size=n_steps) * 0.1 for _ in range(n_controls)]
    gen = hamiltonian(H0, *[(Hc[l], pulses[l]) for l in range(n_controls)])
    trajectories = [
        Trajectory(
            random_state_vector(N, rng), gen,
            target_state=random_state_vector(N, rng),
        )
        for _ in range(n_trajectories)
    ]
    return ControlProblem(trajectories, tlist, **kwargs)


def tls_problem(n_steps=500, T=5.0, **kwargs):
    """The README/TLS |0⟩→|1⟩ transfer problem with ``J_T_sm`` defaulted —
    delegates to :func:`grape_tpu_torch.models.tls_problem`."""
    from .functionals import J_T_sm
    from .models import tls_problem as _tls

    kwargs.setdefault("J_T", J_T_sm)
    return _tls(n_steps=n_steps, T=T, **kwargs)


def stirap_problem(lambda_b=0.0, n_steps=500, **kwargs):
    """STIRAP 3-level ladder with an optional intermediate-level
    population running cost ``g_b = |Ψ_1|²`` (a torch function: its
    co-state source comes from ``torch.autograd``)."""
    from .functionals import J_T_ss
    from .shapes import blackman

    w1, w2, w3 = 0.0, 10.0, 5.0
    wP, wS = 9.5, 4.5
    dP = (w2 - w1) - wP
    dS = (w2 - w3) - wS
    H0 = np.diag([0.0, dP, dP - dS]).astype(complex)
    H1P_re = 0.5 * np.array([[0, 1, 0], [1, 0, 0], [0, 0, 0]], dtype=complex)
    H1P_im = 0.5 * np.array(
        [[0, 1j, 0], [-1j, 0, 0], [0, 0, 0]], dtype=complex
    )
    H1S_re = 0.5 * np.array([[0, 0, 0], [0, 0, 1], [0, 1, 0]], dtype=complex)
    H1S_im = 0.5 * np.array(
        [[0, 0, 0], [0, 0, 1j], [0, -1j, 0]], dtype=complex
    )

    def eps_P(t):
        return float(blackman(t, 1.0, 5.0))

    def eps_S(t):
        return float(blackman(t, 0.0, 4.0))

    def eps_P_im(t):
        return 0.0

    def eps_S_im(t):
        return 0.0

    H = hamiltonian(
        H0, (H1P_re, eps_P), (H1P_im, eps_P_im),
        (H1S_re, eps_S), (H1S_im, eps_S_im),
    )
    tlist = np.linspace(0, 5, n_steps + 1)
    traj = Trajectory(
        np.array([1, 0, 0], dtype=complex), H,
        target_state=np.array([0, 0, 1], dtype=complex),
    )

    def g_b(Psi, trajectories, tl, n):
        return Psi[..., 1].abs() ** 2

    kwargs.setdefault("J_T", J_T_ss)
    return ControlProblem(
        [traj], tlist, g_b=g_b, lambda_b=lambda_b, **kwargs
    )


def cnot_problem(**kwargs):
    """2-qubit CNOT with 6 drive controls under a Chebyshev propagator."""
    from .amplitudes import ShapedAmplitude
    from .functionals import J_T_sm
    from .shapes import box

    I2 = np.eye(2, dtype=complex)
    sx = np.array([[0, 1], [1, 0]], dtype=complex)
    sy = np.array([[0, -1j], [1j, 0]], dtype=complex)
    sz = np.array([[1, 0], [0, -1]], dtype=complex)
    T = 1.0
    tlist = np.arange(0, T + 1e-9, 0.001)
    E0 = 0.1

    def shape(t):
        return box(t, 0.0, T)

    controls = [(lambda t, E0=E0: E0) for _ in range(6)]
    amps = [ShapedAmplitude(c, shape) for c in controls]
    H0 = np.pi / 2 * np.kron(sy, sy)
    ops = [
        np.kron(sx, I2), np.kron(sy, I2), np.kron(sz, I2),
        np.kron(I2, sx), np.kron(I2, sy), np.kron(I2, sz),
    ]
    H = hamiltonian(H0, *zip(ops, amps))
    CNOT = np.array(
        [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]],
        dtype=complex,
    )
    basis = np.eye(4, dtype=complex)
    trajectories = [
        Trajectory(basis[:, k], H, target_state=CNOT @ basis[:, k])
        for k in range(4)
    ]
    kwargs.setdefault("J_T", J_T_sm)
    kwargs.setdefault("prop_method", "cheby")
    return ControlProblem(trajectories, tlist, **kwargs)
