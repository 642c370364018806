"""The walkthrough of ``docs/tutorial.md`` through the port: an entangling
gate on two coupled transmons of ``d`` levels each, assembled by hand
(operators, a shaped amplitude, the Hamiltonian, the logical basis and its
targets), optimized with box bounds, and the result read back.  The
tutorial leaves the gate open (``gate = ...``); here it is the CZ.

Run:  python -m grape_tpu_torch.examples.tutorial [--device cpu]
"""

import numpy as np

from grape_tpu_torch import ControlProblem, Trajectory, optimize_problem
from grape_tpu_torch.amplitudes import ShapedAmplitude
from grape_tpu_torch.functionals import J_T_sm
from grape_tpu_torch.generators import hamiltonian
from grape_tpu_torch.shapes import flattop

from . import run_cli

GATE = np.diag([1, 1, 1, -1]).astype(complex)  # the CZ


def setup(iter_stop=100):
    """``(trajectories, tlist, kwargs)`` and the ``ControlProblem``."""
    # a two-qubit system: two transmons of d levels each
    d = 3
    dim = d * d
    b = np.diag(np.sqrt(np.arange(1, d)), 1)  # lowering operator
    I = np.eye(d)
    b1, b2 = np.kron(b, I), np.kron(I, b)
    n1, n2 = b1.T.conj() @ b1, b2.T.conj() @ b2
    # units: time in 1/E0
    T, n_steps = 100.0, 500
    tlist = np.linspace(0.0, T, n_steps + 1)
    # the control: a flattop envelope times the optimized pulse
    guess = 0.05 * np.ones(n_steps)  # ε guess (midpoints)
    S = flattop(tlist, T=T, t_rise=10.0)  # envelope on tlist
    drive = ShapedAmplitude(guess, shape=S)
    # the Hamiltonian
    delta = 0.5  # qubit-qubit detuning
    alpha = -2.0  # anharmonicity
    J = 0.02  # static coupling
    H0 = (delta * n2 + 0.5 * alpha * (n1 @ n1 - n1)
          + 0.5 * alpha * (n2 @ n2 - n2)
          + J * (b1.T.conj() @ b2 + b2.T.conj() @ b1))
    Hd = b1 + b1.T.conj()  # drive on transmon 1
    H = hamiltonian(H0, (Hd, drive))
    # the target: the logical basis and the gate's images of it
    basis = np.eye(dim, dtype=complex)[:4]  # |00⟩, |01⟩, |10⟩, |11⟩
    targets = GATE.conj().T @ basis
    trajs = [Trajectory(b0, H, target_state=t0)
             for b0, t0 in zip(basis, targets)]
    problem = ControlProblem(trajs, tlist, J_T=J_T_sm, iter_stop=iter_stop)
    return trajs, tlist, {"J_T": J_T_sm}, problem


def main(device=None, dtype=None, iter_stop=100, converged_below=1e-3):
    *_, problem = setup(iter_stop)
    message = f"J_T < {converged_below:g}"
    result = optimize_problem(
        problem,
        check_convergence=lambda r: (
            message if r.J_T < converged_below else None),
        upper_bound=0.5, lower_bound=-0.5,  # box bounds (L-BFGS-B)
        print_iters=True,
        device=device, dtype=dtype,
    )
    print(result)  # summary table
    eps_opt = result.optimized_controls[0]
    assert len(eps_opt) == len(problem.tlist)
    assert float(np.max(np.abs(eps_opt))) <= 0.5 + 1e-6
    return result


if __name__ == "__main__":
    run_cli(main)
