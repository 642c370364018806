"""The examples of ``examples/01``–``07`` and the walkthrough of
``docs/tutorial.md`` through ``grape_tpu_torch``, one module each:

- ``tls_state_transfer`` (01), ``stirap_guard_penalty`` (02),
  ``robust_ensemble`` (03: ``main`` and ``main_robust_gate``),
  ``xgate_observables`` (04), ``nonlinear_amplitude`` (05),
  ``subspace_gate_fat_batch`` (06), ``krotov_continuation`` (07),
  ``tutorial``.

Each module has ``setup()``, the problem as ``(trajectories, tlist,
kwargs)`` (what ``compile_problem`` takes), and ``main(device=None,
dtype=None)``, which optimizes it with the example's own settings, prints
what the example prints, checks the example's own assertions and returns
the result.  ``device=None`` is the CUDA device (raising without one);
``device="cpu"`` runs the plain PyTorch versions.  The functions the
scripts write in ``jax.numpy`` are torch code here.  Run one as

    python -m grape_tpu_torch.examples.<name> [--device cpu]
        [--dtype complex64|complex128]
"""

import argparse

import numpy as np

__all__ = ["NAMES", "run_cli"]

NAMES = ("tls_state_transfer", "stirap_guard_penalty", "robust_ensemble",
         "xgate_observables", "nonlinear_amplitude",
         "subspace_gate_fat_batch", "krotov_continuation", "tutorial")


def run_cli(*mains):
    """Run ``mains`` in turn with ``--device`` and ``--dtype`` from the
    command line."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device)")
    parser.add_argument("--dtype", default=None,
                        choices=("complex64", "complex128"))
    args = parser.parse_args()
    dtype = None if args.dtype is None else np.dtype(args.dtype)
    for main in mains:
        main(device=args.device, dtype=dtype)
