"""Gate optimization with per-step observables: a TLS X-gate over the
tomography-complete basis {|0⟩, |1⟩, |+⟩, |+i⟩} (BASELINE config 2),
with a fluence running cost and a forward-propagation callback that
records the excited-state population of every trajectory at every time
step (``examples/04_xgate_observables.py`` through the port).

Run:  python -m grape_tpu_torch.examples.xgate_observables [--device cpu]
"""

import numpy as np

from grape_tpu_torch import optimize_problem
from grape_tpu_torch.models import tls_xgate_problem

from . import run_cli


def pop1(Psi, tlist, n):
    """The |1⟩ population of each trajectory, ``(K,)``."""
    return Psi[..., 1].abs() ** 2


def setup():
    problem = tls_xgate_problem(n_steps=500, lambda_a=1e-4, iter_stop=20)
    kwargs = {k: v for k, v in problem.kwargs.items() if k != "iter_stop"}
    return problem.trajectories, problem.tlist, kwargs


def main(device=None, dtype=None):
    problem = tls_xgate_problem(n_steps=500, lambda_a=1e-4, iter_stop=20)
    traces = []

    def record(values, tlist):
        traces.append(np.real(values[0]))  # (N_T+1, K)

    result = optimize_problem(
        problem,
        fw_prop_callback=record,
        fw_prop_observables=[pop1],
        check_convergence=lambda r: (
            "J_T < 10⁻⁴" if r.J_T < 1e-4 else ""
        ),
        rethrow_exceptions=True,
        device=device, dtype=dtype,
    )
    print(result)
    print(f"\ngate infidelity J_T = {result.J_T:.3e} "
          f"after {result.iter} iterations (J_a fluence = {result.J_a:.3f})")
    pops = traces[-1]  # final accepted iterate: (N_T+1, K)
    print("final |1⟩ populations at T per basis state:",
          np.round(pops[-1], 4))
    print(f"peak |1⟩ population during the gate: {pops.max():.4f}")
    return result


if __name__ == "__main__":
    run_cli(main)
