"""The Chebyshev scan: one direction (forward, or the adjoint co-state
chain) of ``N_T`` steps for ``K`` states under one shared generator
``H_n = H0 + sum_t c[n, t] Op_t``, each step the series
``sum_m c_m T_m(H~_n) psi`` of ``n`` terms by the three-term recursion.

The term count is what the inputs need: the smallest ``n`` whose
remaining Bessel coefficients ``|J_k(alpha)|``, ``k >= n``, all lie below
``TOLERANCE``, at ``alpha = dt dE / 2`` with ``dE`` the width of an
interval that holds the spectrum of every step's generator: the drift's
eigenvalue range widened by ``2 sum_l |eps_l|_max radius_l``, at the
evaluation's own largest pulse values.  (The program sizes its series at
its envelope, which holds those values, widened by 5% on each side, and
adds terms past the last one above the tolerance: never fewer terms while
its coefficient routine looks far enough, to ``alpha`` about 12.)"""

import math

import numpy as np

__all__ = ["TOLERANCE", "alpha", "terms", "flops", "nbytes", "direction"]

C64, F32 = 8, 4
TOLERANCE = 1e-14


def alpha(dt, h0_range, op_radii, amplitudes):
    """``dt dE / 2`` at the pulse's largest values ``amplitudes`` (one a
    control, each control driving its own operator)."""
    dE = (float(h0_range[1]) - float(h0_range[0])
          + 2.0 * sum(abs(a) * r for a, r in zip(amplitudes, op_radii)))
    return 0.5 * float(dt) * dE


def terms(a, tolerance=TOLERANCE):
    """Smallest ``n`` with ``|J_k(a)| < tolerance`` for every ``k >= n``
    (at least 2: the scan's own least).  Past ``k > |a|`` the Bessel
    functions fall monotonically, so the look ends well past both."""
    from scipy.special import jv

    ks = np.arange(int(math.ceil(2.0 * abs(a))) + 60)
    big = np.nonzero(np.abs(jv(ks, abs(a))) >= tolerance)[0]
    return max(2, int(big[-1]) + 1 if len(big) else 1)


def flops(d, K, T, N_T, n):
    """Float32 operations: per step the generator's rows (``T``
    real-by-complex multiply-adds of ``(d, d)`` and the normalisation),
    per term after the first a complex ``(d, d)`` by ``(d, K)`` product,
    the recursion's ``2x - y`` and the weighted sum."""
    per_term = 8.0 * K * d * d + 12.0 * K * d
    return N_T * ((n - 1) * per_term + (4.0 * T + 4.0) * d * d)


def nbytes(d, K, T, N_T, n):
    """Each input read once (the ``T + 1`` operators, the coefficient,
    Chebyshev and phase tables, the initial states); the ``(N_T, K, d)``
    states written once."""
    return (C64 * (T + 1) * d * d + F32 * N_T * T + C64 * N_T * n
            + C64 * N_T + C64 * K * d + C64 * N_T * K * d)


def direction(structure, amplitudes):
    """``(flops, bytes)`` of one direction of the scan for the counted
    ``structure`` at the pulse's largest values ``amplitudes``."""
    st = structure
    n = terms(alpha(st["dt"], st["h0_range"], st["op_radii"], amplitudes))
    return (flops(st["d"], st["K"], st["T"], st["N_T"], n),
            nbytes(st["d"], st["K"], st["T"], st["N_T"], n))
