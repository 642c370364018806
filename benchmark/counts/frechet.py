"""The Fréchet traces ``trj[n, k, t] = tr(Op_t L(A_n, psi chi^+))`` over
``N_T`` steps of one generator and ``K`` directions: the cheaper of the
rank-factored and the dense evaluation of the degree-16 Taylor polynomial at
``A / 2^s`` with ``s`` pair doublings."""

__all__ = ["needed_flops", "flops", "nbytes", "of_call"]

C64, F32 = 8, 4


def needed_flops(d, K, T, N_T, s):
    """Float32 operations that the traces need, for one generator.

    The direction has rank one, so ``L = sum_{i+j<=15} c_{i+j+1} (A^i
    psi)(chi^+ A^j)`` has rank <= 16 and needs no dense product: 15 + 15
    matrix-vector products build the two Krylov sets and 136 real-by-complex
    multiply-adds of vectors fold the coefficients in.  Each doubling
    ``L <- E_j L + L E_j`` doubles the rank: both sets are extended by
    ``E``, the polynomial at ``A / 2^s`` (six dense products, needed only
    then).  The traces are ``sum_ab Op_t[a,b] Z[b,a]`` over ``Z = sum_r x_r
    w_r^+`` (``16 * 2^s`` outer products and ``T`` matrix-sized
    multiply-adds).  Where that count exceeds the dense evaluation's (small
    d, large s), the dense one is taken."""
    mv = 8.0 * d * d            # complex (d, d) by (d,) product
    cmm = 8.0 * d ** 3          # complex (d, d) by (d, d) product
    gen = (4.0 * T + 2.0) * d * d   # A_n = -i dt (H0 + sum_t c_t Op_t)
    rank = 16 * 2 ** s
    factored = gen + (6 * cmm if s else 0.0) + K * (
        30 * mv
        + 136 * 4.0 * d
        + 2 * 16 * (2 ** s - 1) * mv
        + rank * mv
        + T * mv
    )
    dense = gen + (5 + s) * cmm + K * ((12 + 2 * s) * cmm + T * mv)
    return N_T * min(factored, dense)


def flops(d, G, gs, T, N_T, s):
    """``G`` generators of ``gs`` directions each."""
    return G * needed_flops(d, gs, T, N_T, s)


def nbytes(d, G, K, T, N_T, coeff_values):
    """Reads the operators, the coefficients and time steps, the states and
    co-states ``(N_T, K, d)``; writes ``trj (N_T, K, T)`` complex64."""
    return (C64 * (G * d * d + G * T * d * d) + F32 * (coeff_values + N_T)
            + 2 * C64 * N_T * K * d + C64 * N_T * K * T)


def of_call(shape):
    G, K = shape["G"], shape["K"]
    return (flops(shape["d"], G, K // G, shape["T"], shape["N_T"], shape["s"]),
            nbytes(shape["d"], G, K, shape["T"], shape["N_T"],
                   shape["coeff_values"]))
