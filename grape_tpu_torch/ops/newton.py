"""Krylov (Arnoldi) propagator, in plain PyTorch.

Counterpart of ``grape_tpu/ops/newton.py`` (the reference's Newton
propagator, for generators that need not be Hermitian): ``exp(A) ψ``
approximated in a fixed-dimension Krylov subspace,

    exp(A) ψ ≈ β · V_m · exp(H_m) · e_1,

with ``V_m`` the Arnoldi basis of ``span{ψ, Aψ, ..., A^{m-1}ψ}`` (modified
Gram-Schmidt) and ``H_m`` the (m×m) Hessenberg projection; the small
``exp(H_m)`` goes through ``ops.expm.expm``.  Only matrix-vector products,
batched over the leading axes of ψ.  The reference has no kernel here
either.
"""

import torch

from .expm import expm

__all__ = ["arnoldi_expmv"]


def arnoldi_expmv(matvec, psi, m=30, substeps=1):
    """``exp(A) ψ`` for the batched linear operator ``matvec``, which maps
    ``(..., d)`` to ``(..., d)``.

    ``m`` is the Krylov dimension; ``substeps`` splits the action into
    ``substeps`` applications of ``exp(A/substeps)`` for large ``‖A‖``.  A
    zero state stays zero.
    """
    r = int(substeps)
    p = psi
    for _ in range(r):
        beta = torch.linalg.vector_norm(p, dim=-1)  # (...,)
        safe_beta = torch.where(beta > 0, beta, torch.ones_like(beta)).to(
            p.dtype)
        V = [p / safe_beta[..., None]]
        zero = torch.zeros_like(safe_beta)
        cols = []  # the columns of the Hessenberg matrix H_m
        for j in range(m):
            w = matvec(V[j]) / r
            col = []
            for i in range(j + 1):
                h = torch.linalg.vecdot(V[i], w)  # Σ conj(V_i)·w
                w = torch.addcmul(w, h[..., None], V[i], value=-1)
                col.append(h)
            if j + 1 < m:
                hnext = torch.linalg.vector_norm(w, dim=-1)
                safe_h = torch.where(hnext > 1e-30, hnext,
                                     torch.ones_like(hnext)).to(p.dtype)
                col.append(hnext.to(p.dtype))
                V.append(w / safe_h[..., None])
            cols.append(torch.stack(col + [zero] * (m - len(col)), dim=-1))
        E = expm(torch.stack(cols, dim=-1))  # (..., m, m)
        coeffs = safe_beta[..., None] * E[..., :, 0]  # β exp(H_m) e_1
        out = torch.einsum("...i,...id->...d", coeffs,
                           torch.stack(V, dim=-2))
        p = torch.where(beta[..., None] > 0, out, p)
    return p
