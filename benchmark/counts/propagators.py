"""The propagator kernels: ``U = exp(-i dt H)`` of ``N_T * G`` steps and
generators, by the degree-16 Taylor polynomial at ``A / 2^s`` (six complex
products) and ``s`` squarings."""

__all__ = ["flops", "nbytes", "of_call"]

C64, F32 = 8, 4


def flops(d, G, N_T, s):
    return N_T * G * (6 + s) * 8.0 * d ** 3


def nbytes(d, G, T, N_T, coeff_values):
    """Reads ``H0 (G, d, d)``, ``ops (G, T, d, d)``, the coefficients and the
    time steps (float32); writes ``U (N_T, G, d, d)``."""
    return (C64 * (G * d * d + G * T * d * d) + F32 * (coeff_values + N_T)
            + C64 * N_T * G * d * d)


def of_call(shape):
    """``(flops, bytes)`` of one call of the propagator wrapper."""
    return (flops(shape["d"], shape["G"], shape["N_T"], shape["s"]),
            nbytes(shape["d"], shape["G"], shape["T"], shape["N_T"],
                   shape["coeff_values"]))
