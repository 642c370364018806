"""Batched matrix exponential in plain PyTorch.

Counterpart of ``grape_tpu/ops/expm.py`` (the ``ExpProp`` propagator):
scaling-and-squaring with one scaling exponent ``s`` shared by the batch.
The core approximant is Padé-13 with ``torch.linalg.solve`` in double
precision (reference-accuracy parity) and a matmul-only degree-16 Taylor
polynomial (Paterson-Stockmeyer in A⁴) in single precision — the arithmetic
the CUDA kernels of ``hopper_prop`` / ``hopper_frechet`` repeat.

Never differentiated through: GRAPE computes exact per-step gradients with
the Fréchet functions in ``frechet.py``.
"""

import math

import torch

__all__ = ["expm", "expm_pade13", "expm_taylor_ps"]

# Padé-13 numerator coefficients (Higham 2005). float64 exact.
_B = (
    64764752532480000.0,
    32382376266240000.0,
    7771770303897600.0,
    1187353796428800.0,
    129060195264000.0,
    10559470521600.0,
    670442572800.0,
    33522128640.0,
    1323241920.0,
    40840800.0,
    960960.0,
    16380.0,
    182.0,
    1.0,
)
_THETA13_F64 = 5.371920351148152
# Single precision theta for Padé-13 (Higham 2005, Table 2.3 single column):
_THETA13_F32 = 3.925724783138660

# Taylor scaling-and-squaring parameters: degree-16 Paterson-Stockmeyer for
# single precision (matmul-only, no LU solve).
_TAYLOR_DEGREE = 16
_THETA_TAYLOR_F32 = 2.0  # conservative: ||A/2^s|| <= 2 with m=16 gives
                          # truncation error well below f32 roundoff
_FACT_INV = tuple(1.0 / math.factorial(k) for k in range(_TAYLOR_DEGREE + 1))


def _is_single(dtype):
    return dtype in (torch.complex64, torch.float32)


def _theta13(dtype):
    return _THETA13_F32 if _is_single(dtype) else _THETA13_F64


def _eye_like(A):
    return torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)


def expm_pade13(A):
    """Padé-13 approximant of expm(A) without scaling (valid for small norm)."""
    ident = _eye_like(A)
    A2 = A @ A
    A4 = A2 @ A2
    A6 = A2 @ A4
    b = _B
    U = A @ (
        A6 @ (b[13] * A6 + b[11] * A4 + b[9] * A2)
        + b[7] * A6 + b[5] * A4 + b[3] * A2 + b[1] * ident
    )
    V = (
        A6 @ (b[12] * A6 + b[10] * A4 + b[8] * A2)
        + b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * ident
    )
    return torch.linalg.solve(V - U, V + U)


def expm_taylor_ps(A, degree=_TAYLOR_DEGREE):
    """Degree-`degree` Taylor approximant of expm(A) via Paterson-Stockmeyer
    (matmul-only; for scaled inputs with ``||A|| <= theta``)."""
    ident = _eye_like(A)
    p = 4  # block size: powers A^1..A^4
    A2 = A @ A
    A3 = A2 @ A
    A4 = A3 @ A
    powers = [ident, A, A2, A3]
    n_blocks = (degree + 1 + p - 1) // p
    # E = sum_{b} (A^4)^b * (sum_{r<4} c_{4b+r} A^r), evaluated by Horner in A4
    E = None
    for b in reversed(range(n_blocks)):
        blk = None
        for r in range(p):
            k = 4 * b + r
            if k > degree:
                continue
            term = _FACT_INV[k] * powers[r]
            blk = term if blk is None else blk + term
        E = blk if E is None else blk + A4 @ E
    return E


def _norm_squarings(A, theta, max_squarings):
    """``max(0, ceil(log2(max 1-norm over the batch / theta)))``, capped."""
    norm = float(torch.max(torch.sum(torch.abs(A), dim=-2)))
    s = max(0.0, math.ceil(math.log2(max(norm, 1e-300) / theta)))
    return int(min(s, max_squarings))


def expm(A, max_squarings=32, squarings=None):
    """Matrix exponential of a batch of square matrices ``A (..., d, d)``.

    Scaling-and-squaring; the scaling exponent ``s`` is shared across the
    batch (from the max of the per-matrix 1-norms) unless the static count
    ``squarings`` is given.  Padé-13 in double precision, degree-16 Taylor
    (Paterson-Stockmeyer) in single precision.
    """
    A = torch.as_tensor(A)
    use_taylor = _is_single(A.dtype)
    if squarings is not None:
        s = int(squarings)
    else:
        theta = _THETA_TAYLOR_F32 if use_taylor else _theta13(A.dtype)
        s = _norm_squarings(A, theta, max_squarings)
    As = A * (2.0 ** (-s))
    E = expm_taylor_ps(As) if use_taylor else expm_pade13(As)
    for _ in range(s):
        E = E @ E
    return E
