"""The state scans: ``psi_n = U_n psi_{n-1}`` forward over ``C`` steps
(``C + 1`` states written), or the co-state chain ``chi_{n-1} = U_n^+
chi_n`` (``C`` co-states written, one product fewer unless the window's
co-state is carried out), for ``K`` states in ``G`` groups."""

__all__ = ["flops", "nbytes", "of_call"]

C64 = 8


def flops(d, K, C, chi=False, carry=False):
    products = C - 1 if (chi and not carry) else C
    return max(products, 0) * 8.0 * K * d * d


def nbytes(d, G, K, C, chi=False, carry=False):
    states = C * K * d if chi else (C + 1) * K * d
    return C64 * (C * G * d * d + K * d + states + (K * d if carry else 0))


def of_call(shape):
    return (flops(shape["d"], shape["K"], shape["C"], shape["chi"],
                  shape["carry"]),
            nbytes(shape["d"], shape["G"], shape["K"], shape["C"],
                   shape["chi"], shape["carry"]))
