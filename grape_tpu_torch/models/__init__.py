"""Problem builders for the models that are ported so far."""

from .tls import tls_problem
from .transmon import two_transmon_cz_problem

__all__ = ["tls_problem", "two_transmon_cz_problem"]
