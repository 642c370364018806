"""Nonlinear control parametrization with ``CustomAmplitude``: the drive
``a(ε, t) = A·sin(ε(t))`` is bounded by ±A for any value of the optimized
pulse, and the gradient picks up ``∂a/∂ε = A·cos(ε)`` exactly
(``examples/05_nonlinear_amplitude.py`` through the port; the amplitude is
torch code, mapped with ``torch.func``).

Run:  python -m grape_tpu_torch.examples.nonlinear_amplitude [--device cpu]
"""

import numpy as np
import torch

from grape_tpu_torch import (
    CustomAmplitude, Trajectory, hamiltonian, optimize,
)
from grape_tpu_torch.functionals import J_T_ss
from grape_tpu_torch.shapes import flattop

from . import run_cli

A_MAX = 1.2  # hard physical drive limit enforced by the parametrization


def guess(t):
    return 0.3 * float(flattop(t, T=5.0, t_rise=0.3, func="blackman"))


def setup():
    amp = CustomAmplitude(
        lambda v, t: A_MAX * torch.sin(v[0]),
        guess,
        # analytic envelope (optional; sampled otherwise): |a| <= A,
        # |da/deps| <= A
        bound=lambda amp_max: (A_MAX, np.asarray([A_MAX])),
    )
    sz = np.array([[1, 0], [0, -1]], dtype=complex)
    sx = np.array([[0, 1], [1, 0]], dtype=complex)
    H = hamiltonian(-0.5 * sz, (sx, amp))
    tlist = np.linspace(0, 5, 501)
    traj = Trajectory([1, 0], H, target_state=[0, 1])
    return [traj], tlist, {"J_T": J_T_ss}


def main(device=None, dtype=None):
    trajectories, tlist, kwargs = setup()
    result = optimize(trajectories, tlist, **kwargs, iter_stop=25,
                      device=device, dtype=dtype)
    eps_opt = np.asarray(result.optimized_controls[0])
    drive = A_MAX * np.sin(eps_opt)
    print(result)
    print(f"J_T = {result.J_T:.3e}")
    print(f"max |physical drive| = {np.max(np.abs(drive)):.4f} "
          f"(hard limit {A_MAX})")
    assert result.J_T < 1e-3
    assert np.max(np.abs(drive)) <= A_MAX
    return result


if __name__ == "__main__":
    run_cli(main)
