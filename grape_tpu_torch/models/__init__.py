"""Problem constructors, the counterparts of ``grape_tpu.models``."""

from .open import dissipative_tls_problem
from .tls import tls_problem, tls_xgate_problem
from .transmon import (
    transmon_ensemble_trajectories, transmon_qutrit_problem, two_transmon_cz_ensemble_problem,
    two_transmon_cz_problem, two_transmon_subspace_gate_problem,
)

__all__ = [
    "tls_problem", "tls_xgate_problem", "dissipative_tls_problem",
    "transmon_qutrit_problem", "two_transmon_cz_problem",
    "two_transmon_subspace_gate_problem",
    "two_transmon_cz_ensemble_problem", "transmon_ensemble_trajectories",
]
