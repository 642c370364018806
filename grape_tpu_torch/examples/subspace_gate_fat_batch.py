"""Fat-batch gate synthesis: a random unitary on a subspace of a
two-transmon register, optimized over its basis-state trajectories under
ONE shared generator (``examples/06_subspace_gate_fat_batch.py`` through
the port): the shared forward scan and the Fréchet-trace kernel serve any
number of basis states.

Run:  python -m grape_tpu_torch.examples.subspace_gate_fat_batch [--device cpu]
"""

import numpy as np

from grape_tpu_torch import optimize_problem
from grape_tpu_torch.models import two_transmon_subspace_gate_problem

from . import run_cli


def _problem():
    # a small instance of the fat-batch family (on a card: d = 10..32,
    # n_basis = 64, complex64, the same code path).  A random subspace
    # unitary is only partly reachable with two drive controls; the
    # example shows steady infidelity descent
    return two_transmon_subspace_gate_problem(
        d=3, n_basis=6, n_steps=100, T=10.0, E0=0.2, J=0.3,
        iter_stop=60,
    )


def setup():
    problem = _problem()
    kwargs = {k: v for k, v in problem.kwargs.items() if k != "iter_stop"}
    return problem.trajectories, problem.tlist, dict(
        kwargs, gradient_method="gradgen")


def main(device=None, dtype=None):
    J0 = []
    result = optimize_problem(
        _problem(),
        gradient_method="gradgen",
        callback=lambda wrk, it: J0.append(wrk.result.J_T) or (),
        rethrow_exceptions=True,
        device=device, dtype=dtype,
    )
    print(result)
    print(f"\nsubspace-gate infidelity J_T = {result.J_T:.3e} "
          f"(guess: {J0[0]:.3e}, {J0[0] / result.J_T:.0f}x reduction) "
          f"after {result.iter} iterations over "
          f"{len(result.tau_vals)} basis-state trajectories")
    # the tau vector holds the per-basis-state overlaps with the target
    print("min |tau_k| =", float(np.min(np.abs(result.tau_vals))))
    return result


if __name__ == "__main__":
    run_cli(main)
