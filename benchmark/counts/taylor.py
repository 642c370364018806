"""One evaluation of J_T and its gradient by the time-vectorized Taylor
series: the forward propagators and chains as for the gradient generator,
then for each order one product of ``H_n^+`` with the ``K (L + 1)``
vectors of the recursion and the ``L`` products of the control operators
with the ``K`` co-states, and the sums over the orders."""

__all__ = ["pass_flops", "evaluation_flops"]


def pass_flops(d, K, L, N_T, orders):
    mv = 8.0 * d * d
    first = N_T * K * L * mv
    per_order = N_T * (K * (L + 1) * mv + K * L * mv + 8.0 * K * L * d)
    return first + (orders - 1) * per_order + N_T * 8.0 * K * L * d


def evaluation_flops(d, G, gs, L, N_T, s, orders):
    K = G * gs
    cmm, mv = 8.0 * d ** 3, 8.0 * d * d
    return (N_T * G * (6 + s) * cmm + N_T * K * mv + (N_T - 1) * K * mv
            + pass_flops(d, K, L, N_T, orders))
