"""STIRAP with a state-dependent running cost: suppress the population of
the lossy intermediate level while still transferring |1⟩→|3⟩
(``examples/02_stirap_guard_penalty.py`` through the port; ``g_b`` is torch
code, its co-state source ``ξ`` comes from ``torch.autograd``).

Run:  python -m grape_tpu_torch.examples.stirap_guard_penalty [--device cpu]
"""

import numpy as np

from grape_tpu_torch import (
    Trajectory, get_controls, hamiltonian, optimize, propagate, substitute,
)
from grape_tpu_torch.functionals import J_T_ss
from grape_tpu_torch.shapes import blackman

from . import run_cli


def g_b(Psi, trajectories, tl, n):
    """The population of the intermediate level |2⟩."""
    return Psi[..., 1].abs() ** 2


def setup():
    dP, dS = 0.5, 0.5
    H0 = np.diag([0.0, dP, dP - dS]).astype(complex)
    HP_re = 0.5 * np.array([[0, 1, 0], [1, 0, 0], [0, 0, 0]], dtype=complex)
    HP_im = 0.5 * np.array([[0, 1j, 0], [-1j, 0, 0], [0, 0, 0]],
                           dtype=complex)
    HS_re = 0.5 * np.array([[0, 0, 0], [0, 0, 1], [0, 1, 0]], dtype=complex)
    HS_im = 0.5 * np.array([[0, 0, 0], [0, 0, 1j], [0, -1j, 0]],
                           dtype=complex)

    def pump(t):
        return float(blackman(t, 1.0, 5.0))

    def stokes(t):
        return float(blackman(t, 0.0, 4.0))

    def zero(t):
        return 0.0

    def zero2(t):
        return 0.0

    H = hamiltonian(
        H0, (HP_re, pump), (HP_im, zero), (HS_re, stokes), (HS_im, zero2)
    )
    tlist = np.linspace(0, 5, 501)
    traj = Trajectory([1, 0, 0], H, target_state=[0, 0, 1])
    # xi is generated from g_b by torch.autograd
    return [traj], tlist, {"J_T": J_T_ss, "g_b": g_b, "lambda_b": 0.4}


def main(device=None, dtype=None):
    trajectories, tlist, kwargs = setup()
    result = optimize(
        trajectories, tlist, **kwargs,
        iter_stop=100,
        check_convergence=lambda r: bool(r.J_T <= 1e-2 and r.J_b <= 1e-2),
        print_iter_info=["iter.", "J_T", "J_b", "ǁΔϵǁ", "ΔJ", "secs"],
        device=device, dtype=dtype,
    )
    print(result)

    # re-propagate under the optimized pulses to inspect the dynamics
    traj = trajectories[0]
    H = traj.generator
    H_opt = substitute(H, list(zip(get_controls(H),
                                   result.optimized_controls)))
    dynamics = propagate(traj.initial_state, H_opt, tlist, storage=True,
                         device=device, dtype=dtype)
    p2_max = float(np.max(np.abs(dynamics[:, 1]) ** 2))
    p3_final = float(np.abs(dynamics[-1, 2]) ** 2)
    print(f"final |3⟩ population: {p3_final:.4f}")
    print(f"peak intermediate |2⟩ population: {p2_max:.4f}")
    return result


if __name__ == "__main__":
    run_cli(main)
