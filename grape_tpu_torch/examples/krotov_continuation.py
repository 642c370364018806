"""Krotov's method and cross-method continuation (Krotov → GRAPE): a few
monotonic first-order Krotov updates far from the optimum, then GRAPE's
quasi-Newton steps from where they left off
(``examples/07_krotov_continuation.py`` through the port).

Run:  python -m grape_tpu_torch.examples.krotov_continuation [--device cpu]
"""

import numpy as np

from grape_tpu_torch import (
    Trajectory, hamiltonian, optimize, optimize_krotov,
)
from grape_tpu_torch.functionals import J_T_sm
from grape_tpu_torch.shapes import flattop

from . import run_cli

T = 5.0


def guess_pulse(t):
    return 0.2 * float(flattop(t, T=T, t_rise=0.3, func="blackman"))


def update_shape(t):
    """S(t) ∈ [0, 1]: freeze the pulse ends, update the interior."""
    return float(flattop(t, T=T, t_rise=0.3, func="blackman"))


def setup():
    sigma_z = np.array([[1, 0], [0, -1]], dtype=complex)
    sigma_x = np.array([[0, 1], [1, 0]], dtype=complex)
    H = hamiltonian(-0.5 * sigma_z, (sigma_x, guess_pulse))
    tlist = np.linspace(0, T, 501)
    trajectory = Trajectory([1, 0], H, target_state=[0, 1])
    return [trajectory], tlist, {"J_T": J_T_sm}


def main(device=None, dtype=None):
    trajectories, tlist, kwargs = setup()
    print("== Krotov (monotonic first-order updates) ==")
    kres = optimize_krotov(
        trajectories, tlist, **kwargs,
        lambda_a=2.0, update_shape=update_shape, iter_stop=4,
        rethrow_exceptions=True, device=device, dtype=dtype,
    )
    assert kres.iter == 4
    J_krotov = kres.J_T
    assert J_krotov < 0.5, J_krotov  # well off the guess's 0.95

    print("\n== GRAPE continuation (quasi-Newton finish) ==")
    res = optimize(
        trajectories, tlist, **kwargs,
        continue_from=kres, iter_stop=10,
        rethrow_exceptions=True, device=device, dtype=dtype,
    )
    assert res.J_T < 1e-3, res.J_T
    assert res.iter > 4  # iteration numbering continues
    print(f"\nKrotov J_T {J_krotov:.3e} -> GRAPE J_T {res.J_T:.3e}")
    print("OK")
    return res


if __name__ == "__main__":
    run_cli(main)
