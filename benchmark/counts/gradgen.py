"""One evaluation of J_T and its gradient by the gradient generator: the
forward propagators (formed once: a second formation is not needed work),
the forward and co-state chains, and the Fréchet traces of each group."""

from . import frechet

__all__ = ["evaluation_flops"]


def evaluation_flops(d, G, gs, T, N_T, s):
    K = G * gs
    cmm, mv = 8.0 * d ** 3, 8.0 * d * d
    return (N_T * G * (6 + s) * cmm + N_T * K * mv + (N_T - 1) * K * mv
            + frechet.flops(d, G, gs, T, N_T, s))
