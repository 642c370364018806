"""Robust ensemble GRAPE: optimize one pulse pair against many Hamiltonian
samples (detuning spread), optionally sharded over the ranks of a process
group (``examples/03_robust_ensemble.py`` through the port), and the robust
CZ gate ensemble of BASELINE config 5 at a demo size.

Run:  python -m grape_tpu_torch.examples.robust_ensemble [--device cpu]
Sharded: start one process per rank with ``torchrun`` (each calling
``grape_tpu_torch.parallel.init_distributed()`` before ``main``); the
sharded evaluation runs when the world size divides K.
"""

import torch.distributed as dist

import numpy as np

from grape_tpu_torch import optimize, optimize_problem
from grape_tpu_torch.functionals import J_T_sm
from grape_tpu_torch.models import (
    transmon_ensemble_trajectories, two_transmon_cz_ensemble_problem,
)

from . import run_cli

K = 16  # ensemble size (thousands on a card)


def setup():
    trajectories = transmon_ensemble_trajectories(
        K, d=3, delta_spread=0.05, T=20.0
    )
    tlist = np.linspace(0, 20.0, 201)
    return trajectories, tlist, {"J_T": J_T_sm, "gradient_method": "taylor"}


def sharded_fg(trajectories, tlist, device=None, dtype=None):
    """One evaluation at the guess sharded over the open process group
    (``parallel.build_fg_sharded``), ``(J, grad)``; None when no group is
    open or its size does not divide K."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    if len(trajectories) % dist.get_world_size() != 0:
        return None
    from grape_tpu_torch.fg import compile_problem
    from grape_tpu_torch.parallel import build_fg_sharded, make_mesh

    cp = compile_problem(trajectories, tlist, J_T=J_T_sm, device=device,
                         dtype=dtype)
    mesh = make_mesh(device=device)
    fg_sharded, _ = build_fg_sharded(cp, mesh)
    J, grad, _ = fg_sharded(cp.guess_pulsevals.reshape(-1))
    print(f"sharded fg over {mesh.mesh.numel()} ranks: J = {float(J):.6f}")
    return float(J), grad


def main(device=None, dtype=None):
    trajectories, tlist, kwargs = setup()
    result = optimize(
        trajectories, tlist, **kwargs,
        iter_stop=30,
        check_convergence=lambda r: bool(r.J_T < 1e-3),
        device=device, dtype=dtype,
    )
    print(result)
    print(f"robust-ensemble J_T over {K} samples: {result.J_T:.3e}")
    # the building block of the sharded path (optimize(mesh=...) runs the
    # whole loop sharded)
    sharded_fg(trajectories, tlist, device=device, dtype=dtype)
    return result


def setup_robust_gate():
    problem = two_transmon_cz_ensemble_problem(
        n_samples=4, d=4, T=25.0, n_steps=250,
    )  # dim = 16 demo size; d = 10 (dim 100) for the real benchmark
    kwargs = {k: v for k, v in problem.kwargs.items() if k != "iter_stop"}
    return problem.trajectories, problem.tlist, kwargs


def main_robust_gate(device=None, dtype=None):
    """Robust GATE ensemble (BASELINE config 5): a CZ on an ensemble of
    perturbed two-transmon Hamiltonians.  Each sample's 4 logical basis
    trajectories share one generator, which the grouped kernels exploit;
    the functional is per-sample coherent and cross-sample incoherent
    (``make_ensemble_gate_functional``)."""
    problem = two_transmon_cz_ensemble_problem(
        n_samples=4, d=4, T=25.0, n_steps=250,
    )
    result = optimize_problem(
        problem, iter_stop=40,
        check_convergence=lambda r: bool(r.J_T < 1e-2),
        device=device, dtype=dtype,
    )
    print(result)
    print(f"robust-CZ ensemble J_T: {result.J_T:.3e}")
    return result


if __name__ == "__main__":
    run_cli(main, main_robust_gate)
