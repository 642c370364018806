"""Two-level-system |0⟩→|1⟩ state transfer, the canonical GRAPE example
(``examples/01_tls_state_transfer.py`` through the port).

Run:  python -m grape_tpu_torch.examples.tls_state_transfer [--device cpu]
"""

import numpy as np

from grape_tpu_torch import Trajectory, hamiltonian, optimize
from grape_tpu_torch.functionals import J_T_sm
from grape_tpu_torch.shapes import flattop

from . import run_cli


def guess_pulse(t):
    """A low-amplitude flattop guess."""
    return 0.2 * float(flattop(t, T=5, t_rise=0.3, func="blackman"))


def setup():
    sigma_z = np.array([[1, 0], [0, -1]], dtype=complex)
    sigma_x = np.array([[0, 1], [1, 0]], dtype=complex)
    H = hamiltonian(-0.5 * sigma_z, (sigma_x, guess_pulse))
    tlist = np.linspace(0, 5, 501)
    trajectory = Trajectory([1, 0], H, target_state=[0, 1])
    return [trajectory], tlist, {"J_T": J_T_sm}


def main(device=None, dtype=None):
    trajectories, tlist, kwargs = setup()
    result = optimize(
        trajectories, tlist, **kwargs,
        iter_stop=5,
        check_convergence=lambda r: ("J_T < 10⁻³" if r.J_T < 1e-3 else ""),
        device=device, dtype=dtype,
    )
    print(result)
    print(f"final J_T = {result.J_T:.3e}")
    print(f"max |ε_opt| = {np.max(np.abs(result.optimized_controls[0])):.4f}")
    assert result.J_T < 1e-3
    return result


if __name__ == "__main__":
    run_cli(main)
