"""Chebyshev-polynomial propagator, in numpy (tables) and PyTorch (series).

Counterpart of ``grape_tpu/ops/cheby.py``: approximate ``exp(-i H dt) ψ``
by a Chebyshev series in the spectrally normalized Hamiltonian,

    exp(-i H dt) = e^{-i (ΔE/2 + E_min) dt} Σ_k c_k(α) T_k(H_norm),
    H_norm = 2 (H - E_min I)/ΔE - I,   α = ΔE dt / 2,
    c_k = (2 - δ_k0) (-i)^k J_k(α),

evaluated by the three-term recursion ``φ_{k+1} = 2 H_norm φ_k - φ_{k-1}``.
The Bessel coefficients depend on the (static) spectral envelope; they are
computed on the host per time step, in float64, by the same numpy and scipy
calls as the reference, so both packages get bit-identical tables.
"""

import numpy as np
from scipy.special import jv

__all__ = ["cheby_coeffs", "cheby_apply", "spectral_envelope"]


def cheby_coeffs(alpha, tol=1e-14, max_terms=None):
    """Chebyshev coefficients ``c_k = (2-δ_k0)(-i)^k J_k(α)`` for
    ``exp(-i α x)`` on x ∈ [-1, 1]; truncated once |J_k| < tol (with the
    standard few extra terms for safety).  α may be negative (backward)."""
    a = float(alpha)
    n_est = int(np.ceil(1.2 * abs(a) + 20))
    if max_terms is not None:
        n_est = min(n_est, max_terms)
    ks = np.arange(n_est)
    Js = jv(ks, a)
    # truncation point: last k with |J_k| >= tol, plus a safety margin
    big = np.nonzero(np.abs(Js) >= tol)[0]
    n = (int(big[-1]) + 3) if len(big) else 3
    n = min(n, n_est)
    c = (2.0 - (ks[:n] == 0)) * ((-1j) ** ks[:n]) * Js[:n]
    return c.astype(np.complex128)


def spectral_envelope(H0, ops, coeff_min, coeff_max, margin=0.05):
    """Conservative spectral range of ``H0 + Σ_j c_j Op_j`` for
    ``c_j ∈ [coeff_min_j, coeff_max_j]`` (Hermitian case):
    ``λ(H0) ∓ Σ_j max|c_j|·‖Op_j‖₂``, widened by ``margin``.

    H0 (K, d, d), ops (K, T, d, d) numpy; returns (E_min, E_max) floats.
    """
    H0 = np.asarray(H0)
    ops = np.asarray(ops)
    E_min = np.inf
    E_max = -np.inf
    for k in range(H0.shape[0]):
        w = np.linalg.eigvalsh(0.5 * (H0[k] + H0[k].conj().T))
        lo, hi = w[0], w[-1]
        for j in range(ops.shape[1]):
            nrm = np.linalg.norm(ops[k, j], 2)
            cmax = max(abs(coeff_min[j]), abs(coeff_max[j]))
            lo -= cmax * nrm
            hi += cmax * nrm
        E_min = min(E_min, lo)
        E_max = max(E_max, hi)
    span = max(E_max - E_min, 1e-12)
    return float(E_min - margin * span), float(E_max + margin * span)


def cheby_apply(matvec, psi, coeffs, phase):
    """``phase · Σ_k coeffs[k] T_k(H_norm) ψ`` with ``matvec(ψ) = H_norm ψ``.

    ``coeffs`` is one row of a coefficient table as Python numbers, padded
    terms included, ``phase`` a Python number; the recursion is a plain
    Python loop over the terms.  ``matvec`` must return a new tensor: the
    recursion updates its result in place.
    """
    n = len(coeffs)
    phi0 = psi
    acc = coeffs[0] * phi0
    if n == 1:
        return phase * acc
    phi1 = matvec(phi0)
    acc.add_(phi1, alpha=coeffs[1])
    for k in range(2, n):
        # φ_k = 2 H_norm φ_{k-1} - φ_{k-2}, in place on the fresh product
        phi0, phi1 = phi1, matvec(phi1).mul_(2.0).sub_(phi0)
        acc.add_(phi1, alpha=coeffs[k])
    return phase * acc
