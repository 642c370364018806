"""What a pulse needs of the series: the squaring count of the degree-16
Taylor exponential and the order count of the Taylor gradient series, from
the 1-norm bound ``dt (||H0||_1 + sum_l |eps_l|_max ||H_l||_1)`` at the
pulse's own largest values (not at the envelope the program sizes them
by, which may be larger)."""

import math

__all__ = ["THETA", "step_norm", "squarings", "taylor_orders"]

THETA = 2.0   # ||A / 2^s||_1 <= 2 for the degree-16 polynomial in float32


def step_norm(dt, h0_norm, op_norms, amplitudes):
    return dt * (h0_norm + sum(a * n for a, n in zip(amplitudes, op_norms)))


def squarings(norm):
    return max(0, int(math.ceil(math.log2(max(norm, 1e-30) / THETA))))


def taylor_orders(norm, prefactor, tolerance=1e-9, max_order=100):
    """Smallest ``m`` with ``prefactor * m * norm^m / m! < tolerance``, plus
    two, at most ``max_order`` (``None`` past it).  ``tolerance`` 1e-9 is
    the float32 floor of the Taylor series' tolerance."""
    term = max(float(prefactor), 1e-30)
    for m in range(1, max_order + 1):
        term *= max(float(norm), 1e-30) / m
        if m * term < tolerance:
            return min(m + 2, max_order)
    return None
