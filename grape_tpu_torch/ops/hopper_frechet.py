"""Fused rank-1 Fréchet-trace gradient for a shared generator: CUDA kernel,
wrapper and plain PyTorch version.

Counterpart of ``grape_tpu/ops/pallas_frechet.py`` for
``frechet_trace_pallas_shared``:

    trj[n, k, t] = tr(Op_t · L(−i·dt_n·H_n, ψ_nk χ_nk†))

one expm base per step; per direction the M-chain, the Horner recursion
with the shared E history, ``s`` pair doublings, then ``T`` trace
reductions (``csrc/frechet_trace.cu``).  The ``(K, d, d)`` Fréchet factors
never reach device memory as an output.

The TPU kernel's default ``precision="high"`` is an emulated 3-pass bf16
product, acceptable there because each step is independent.  This kernel
uses full float32 FMAs, which is at least as accurate; ``precision`` is
accepted as ``"highest"`` or ``"high"`` and both mean that arithmetic.
There is no K-blocking and no lane padding here: K directions are a loop
inside the block.
"""

import torch

from . import plain_forced
from ._build import check, load_kernels
from .frechet import _frechet_taylor_ps
from .hopper_prop import (
    _check_generator_args, _check_tensor, _grid_blocks, _require, _stream,
)

__all__ = [
    "frechet_trace_shared", "frechet_trace_shared_plain", "launches",
]

launches = {"frechet_trace_shared": 0}

# time steps per batched product of the plain version, so the
# (chunk, K, d, d) intermediates stay bounded
_PLAIN_CHUNK = 50

_PRECISIONS = ("highest", "high")


def frechet_trace_shared_plain(H0, ops, coeffs, dts, psis, chis, n_squarings,
                               precision="high"):
    """Plain PyTorch version of :func:`frechet_trace_shared` (same Taylor
    degree, same static ``s``, same pair doublings), in chunks of
    ``_PLAIN_CHUNK`` time steps."""
    _require(precision in _PRECISIONS, f"unknown precision {precision!r}")
    cdtype = psis.dtype
    N_T, K, d = psis.shape
    T = ops.shape[0]
    s = int(n_squarings)
    scale = 2.0 ** (-s)
    trj = torch.empty((N_T, K, T), dtype=cdtype, device=psis.device)
    chunk = _PLAIN_CHUNK
    for c0 in range(0, N_T, chunk):
        sl = slice(c0, c0 + chunk)
        c = coeffs[sl].to(cdtype)
        dt = dts[sl].to(cdtype)
        H = H0[None] + torch.einsum("nt,tij->nij", c, ops)
        A = (-1j * dt * scale)[:, None, None] * H
        # rank-1 direction R[b, a] = ψ_b conj(χ_a), scaled by 2^-s
        R = scale * torch.einsum("nkb,nka->nkba", psis[sl], chis[sl].conj())
        E, G = _frechet_taylor_ps(A, R)
        for _ in range(s):
            Eb = E[:, None]
            E, G = E @ E, Eb @ G + G @ Eb
        trj[sl] = torch.einsum("tab,nkba->nkt", ops, G)
    return trj


def frechet_trace_shared(H0, ops, coeffs, dts, psis, chis, n_squarings,
                         precision="high"):
    """``trj[n, k, t] = tr(Op_t · L(-i dt_n H_n, ψ_nk χ_nk†))`` fused.

    Args:
      H0:   (d, d) complex64 shared drift
      ops:  (T, d, d) complex64 shared control-term operators
      coeffs: (N_T, T) float32 per-step term coefficients
      dts:  (N_T,) float32
      psis: (N_T, K, d) complex64 forward states ψ(t_n)
      chis: (N_T, K, d) complex64 normalized co-states χ(t_{n+1})
      n_squarings: squaring count ``s`` (runtime integer)

    Returns trj (N_T, K, T) complex64.
    """
    if psis.device.type == "cpu" or plain_forced():
        return frechet_trace_shared_plain(
            H0, ops, coeffs, dts, psis, chis, n_squarings, precision
        )
    _require(precision in _PRECISIONS, f"unknown precision {precision!r}")
    T, d, N_T = _check_generator_args(H0, ops, coeffs, dts)
    device = psis.device
    K = psis.shape[1]
    _check_tensor("psis", psis, torch.complex64, (N_T, K, d), H0.device)
    _check_tensor("chis", chis, torch.complex64, (N_T, K, d), H0.device)
    s = int(n_squarings)
    _require(0 <= s <= 32, f"n_squarings out of range: {s}")
    lib = load_kernels()
    n_blocks = _grid_blocks(device, N_T)
    n_mat = lib.grape_frechet_scratch_matrices(s)
    trj = torch.empty((N_T, K, T), dtype=torch.complex64, device=device)
    scratch = torch.empty(
        (n_blocks * n_mat, d, d), dtype=torch.complex64, device=device
    )
    with torch.cuda.device(device):
        check(lib, lib.grape_frechet_trace(
            H0.data_ptr(), ops.data_ptr(), coeffs.data_ptr(), dts.data_ptr(),
            psis.data_ptr(), chis.data_ptr(), T, d, N_T, K, s,
            scratch.data_ptr(), n_blocks, trj.data_ptr(), _stream(device),
        ), "Frechet trace kernel launch")
    launches["frechet_trace_shared"] += 1
    return trj
