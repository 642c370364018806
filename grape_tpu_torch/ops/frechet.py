"""Matrix exponential with its Fréchet derivative, in plain PyTorch.

Counterpart of ``grape_tpu/ops/frechet.py``: ``expm_frechet`` with the
shared base and the pair doublings (the vectorized gradgen pass), and the two
per-step gradient functions of the per-step backward pass,
``gradgen_step`` (augmented exponential) and ``taylor_grad_step`` (Taylor
recursion with a convergence check).
"""

import torch

from .expm import (
    _B as _PADE_B, _FACT_INV, _TAYLOR_DEGREE, _THETA_TAYLOR_F32, _is_single,
    _norm_squarings, _theta13,
)

__all__ = ["expm_frechet", "gradgen_step", "taylor_grad_step"]


def _frechet_taylor_ps(A, B, degree=_TAYLOR_DEGREE):
    """``(expm(A), L(A,B))`` by degree-``degree`` Taylor Paterson-Stockmeyer
    (matmul-only, for pre-scaled ``‖A‖ ≤ θ``); the Fréchet factor follows
    the same Horner-in-A⁴ loop by the product rule.  ``A (..., d, d)``,
    ``B (..., L, d, d)``."""
    d = A.shape[-1]
    ident = torch.eye(d, dtype=A.dtype, device=A.device)
    A2 = A @ A
    A3 = A2 @ A
    A4 = A3 @ A
    powers = [ident, A, A2, A3]
    Ab = A[..., None, :, :]
    A4b = A4[..., None, :, :]
    # M_r = dA^r[B]: M_r = A M_{r-1} + B A^{r-1}
    M1 = B
    M2 = Ab @ B + B @ Ab
    M3 = Ab @ M2 + B @ A2[..., None, :, :]
    M4 = Ab @ M3 + B @ A3[..., None, :, :]
    dpowers = [None, M1, M2, M3]
    p = 4
    n_blocks = (degree + 1 + p - 1) // p
    E = None
    dE = None
    for b in reversed(range(n_blocks)):
        blk = None
        dblk = None
        for r in range(p):
            k = 4 * b + r
            if k > degree:
                continue
            term = _FACT_INV[k] * powers[r]
            blk = term if blk is None else blk + term
            if dpowers[r] is not None:
                dterm = _FACT_INV[k] * dpowers[r]
                dblk = dterm if dblk is None else dblk + dterm
        if E is None:
            E = blk
            dE = dblk
        else:
            new_dE = M4 @ E[..., None, :, :]
            if dE is not None:
                new_dE = new_dE + A4b @ dE
            if dblk is not None:
                new_dE = new_dE + dblk
            dE = new_dE
            E = blk + A4 @ E
    return E, dE


def _frechet_pade13(A, B):
    """``(expm(A), L(A,B))`` by the Padé-13 approximant with its exact
    Fréchet factor (Al-Mohy & Higham 2009 structure), for pre-scaled
    ``‖A‖ ≤ θ₁₃``.  One LU factorization is shared between the expm solve
    and all ``L`` Fréchet solves."""
    d = A.shape[-1]
    b = _PADE_B
    ident = torch.eye(d, dtype=A.dtype, device=A.device)
    A2 = A @ A
    A4 = A2 @ A2
    A6 = A2 @ A4
    Ab = A[..., None, :, :]
    A2b, A4b, A6b = (X[..., None, :, :] for X in (A2, A4, A6))
    # dA^{2k}[B] chain: M2 = AB+BA, M4 = A2 M2 + M2 A2, M6 = A4 M2 + M4 A2
    M2 = Ab @ B + B @ Ab
    M4 = A2b @ M2 + M2 @ A2b
    M6 = A4b @ M2 + M4 @ A2b
    W1 = b[13] * A6 + b[11] * A4 + b[9] * A2
    W2 = b[7] * A6 + b[5] * A4 + b[3] * A2 + b[1] * ident
    Z1 = b[12] * A6 + b[10] * A4 + b[8] * A2
    Z2 = b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * ident
    W = A6 @ W1 + W2
    U = A @ W
    V = A6 @ Z1 + Z2
    Lw1 = b[13] * M6 + b[11] * M4 + b[9] * M2
    Lw2 = b[7] * M6 + b[5] * M4 + b[3] * M2
    Lz1 = b[12] * M6 + b[10] * M4 + b[8] * M2
    Lz2 = b[6] * M6 + b[4] * M4 + b[2] * M2
    Lw = A6b @ Lw1 + M6 @ W1[..., None, :, :] + Lw2
    Lu = Ab @ Lw + B @ W[..., None, :, :]
    Lv = A6b @ Lz1 + M6 @ Z1[..., None, :, :] + Lz2
    # E = (V-U)^{-1}(V+U);  (V-U) L = Lu + Lv + (Lu - Lv) E
    # one LU of (V-U) for all right-hand sides: columns concatenated
    Q = V - U
    E = torch.linalg.solve(Q, V + U)
    nL = B.shape[-3]
    rhs = Lu + Lv + (Lu - Lv) @ E[..., None, :, :]
    # stack the L right-hand sides as columns for ONE multi-RHS solve:
    # (..., L, d, d) -> (..., d, L*d)
    lead = rhs.shape[:-3]
    rhs_cat = torch.movedim(rhs, -3, -2).reshape(*lead, d, nL * d)
    Lf_cat = torch.linalg.solve(Q, rhs_cat)
    Lf = torch.movedim(Lf_cat.reshape(*lead, d, nL, d), -2, -3)
    return E, Lf


def expm_frechet(A, B, max_squarings=32, squarings=None):
    """``(expm(A), L(A, B))``: the matrix exponential and its Fréchet
    derivative(s) in direction(s) ``B``.

    ``A (..., d, d)``, ``B (..., L, d, d)`` (or ``(..., d, d)``).  Batched
    scaling-and-squaring on the PAIR: base approximant at ``A/2^s``
    (Padé-13 in double precision, matmul-only Taylor-PS in single, matching
    ``expm``), then ``s`` doublings ``(E, L) → (E², EL + LE)``.  The expm
    work is shared across all ``L`` directions.

    ``squarings`` is a static squaring count from a host-side norm
    envelope: an over-estimate is mathematically exact, an under-estimate
    loses base-approximant accuracy — callers must bound ``‖A‖`` from above.
    """
    A = torch.as_tensor(A)
    B = torch.as_tensor(B)
    squeeze = False
    if B.ndim == A.ndim:
        B = B[..., None, :, :]
        squeeze = True
    use_taylor = _is_single(A.dtype)
    if squarings is not None:
        s = int(squarings)
    else:
        theta = _THETA_TAYLOR_F32 if use_taylor else _theta13(A.dtype)
        s = _norm_squarings(A, theta, max_squarings)
    scale = 2.0 ** (-s)
    As = A * scale
    Bs = B * scale  # L(A, B) is linear in B: scales with B
    if use_taylor:
        E, Lf = _frechet_taylor_ps(As, Bs)
    else:
        E, Lf = _frechet_pade13(As, Bs)
    for _ in range(s):
        Eb = E[..., None, :, :]
        E, Lf = E @ E, Eb @ Lf + Lf @ Eb
    if squeeze:
        Lf = Lf[..., 0, :, :]
    return E, Lf


def gradgen_step(H, mu, chi, dt):
    """One backward gradient-generator step.

    Given the (already adjoint) generator ``H (..., d, d)``, control
    derivatives ``mu (..., L, d, d)``, co-state ``chi (..., d)`` and the
    *backward* step ``dt`` (the propagator applied is ``exp(-1j * H * dt)``,
    with ``dt < 0`` for backward propagation of the adjoint generator),
    returns ``(chi_prime, chi_new)`` where

    - ``chi_new (..., d)``      = ``exp(-1j H dt) @ chi``
    - ``chi_prime (..., L, d)`` = ``(∂/∂ε_l exp(-1j H dt)) @ chi``
    """
    H = torch.as_tensor(H)
    mu = torch.as_tensor(mu)
    chi = torch.as_tensor(chi)
    E, Lf = expm_frechet(-1j * dt * H, -1j * dt * mu)
    chi_new = torch.einsum("...ij,...j->...i", E, chi)
    chi_prime = torch.einsum("...lij,...j->...li", Lf, chi)
    return chi_prime, chi_new


def taylor_grad_step(H, mu, chi, dt, max_order=100, tolerance=1e-16,
                     check_convergence=True, with_status=False, scale=None):
    """Taylor-series evaluation of ``(∂/∂ε exp(-1j H dt)) @ chi``.

    Recursion (Kuprov & Rodgers):

        chi' = Σ_{m≥1} (-1j dt)^m / m! · Φ_m
        Φ_1 = mu @ chi
        Φ_m = mu @ H^{m-1} @ chi + H @ Φ_{m-1}

    ``H (..., d, d)``, ``mu (..., L, d, d)``, ``chi (..., d)``.  Returns
    ``chi_prime (..., L, d)``.  With ``check_convergence``, the series stops
    once the norm of the added term (max over the batch) falls below
    ``tolerance``; otherwise exactly ``max_order`` terms are used.  The norm
    is taken on the device and read once per order: this is the per-step
    fallback, the time-vectorized pass uses a static order count instead.

    ``scale`` (a static host-side bound on the norm of ``H``) rescales the
    recursion to iterate with ``H/scale``: the iterates stay O(1) and the
    series weight ``(-i dt scale)^m/m!`` stays in the float32 normal range,
    where the unscaled recursion drives ``Φ_m ~ ‖H‖^m`` toward overflow
    while the coefficient underflows.  Mathematically identical.

    ``with_status`` also returns a 0-d bool tensor: converged iff the
    tolerance stop fired (not the ``max_order`` cap), or no check was asked.
    """
    A = torch.as_tensor(H)
    mu = torch.as_tensor(mu).to(A.dtype)
    chi = torch.as_tensor(chi).to(A.dtype)
    dt = float(dt)
    h = float(scale) if scale is not None and float(scale) > 0 else 1.0
    if h != 1.0:
        A = A / h
    cdt = complex(0.0, -dt * h)
    tolerance = tolerance * h  # the terms below are scaled by h

    Hm_chi = chi  # (H/h)^{m-1} chi, m = 1
    phi = torch.einsum("...lij,...j->...li", mu, chi)
    coeff = cdt
    acc = coeff * phi  # m = 1 term (scaled by h)
    done = False
    m = 2
    while m <= max_order and not done:
        Hm_chi = torch.einsum("...ij,...j->...i", A, Hm_chi)
        phi = (
            torch.einsum("...lij,...j->...li", mu, Hm_chi)
            + torch.einsum("...ij,...lj->...li", A, phi)
        )
        coeff = coeff * cdt / m
        term = coeff * phi
        acc = acc + term
        if check_convergence:
            term_norm = torch.sqrt(
                torch.amax(torch.sum(torch.abs(term) ** 2, dim=-1))
            )
            done = bool(term_norm < tolerance)
        m += 1
    acc = acc / h
    if with_status:
        converged = torch.tensor(
            (not check_convergence) or done, dtype=torch.bool,
            device=acc.device,
        )
        return acc, converged
    return acc
