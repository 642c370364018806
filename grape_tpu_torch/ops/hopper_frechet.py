"""Fused rank-1 Fréchet-trace gradient: CUDA kernel, wrappers and plain
PyTorch versions.

Counterpart of ``grape_tpu/ops/pallas_frechet.py``:
:func:`frechet_trace_shared` replaces ``frechet_trace_pallas_shared`` and
:func:`frechet_trace_pertraj` replaces ``frechet_trace_pallas_pertraj``
(one generator per trajectory, or per group of ``group_size`` contiguous
trajectories; coefficient tables shared or per group):

    trj[n, k, t] = tr(Op_gt · L(−i·dt_n·H_ng, ψ_nk χ_nk†)),   g = k // gs

one expm base per (step, group); per direction the M-chain, the Horner
recursion with the shared E history, ``s`` pair doublings, then ``T`` trace
reductions (``csrc/frechet_trace.cu``, one kernel for both wrappers: the
shared generator is the single group).  The ``(K, d, d)`` Fréchet factors
never reach device memory as an output.

The TPU kernel's default ``precision="high"`` is an emulated 3-pass bf16
product, acceptable there because each step is independent.  This kernel
uses full float32 FMAs, which is at least as accurate; ``precision`` is
accepted as ``"highest"`` or ``"high"`` and both mean that arithmetic.
There is no K-blocking and no lane padding here: a group's directions are a
loop inside the block.  Nor do the TPU kernel's gates on ``d`` (16..128), on
the size of a per-group coefficient table or on the padded output carry
over: the matrices live in a global scratch and products are tiled.
"""

import torch

from . import plain_forced
from ._build import check, load_kernels
from .frechet import _frechet_taylor_ps
from .hopper_prop import (
    _check_group_args, _check_tensor, _grid_blocks, _group_size, _require,
    _squarings, _stream, _window,
)

__all__ = [
    "frechet_trace_shared", "frechet_trace_shared_plain",
    "frechet_trace_pertraj", "frechet_trace_pertraj_plain", "launches",
]

launches = {"frechet_trace_shared": 0, "frechet_trace_pertraj": 0}

# directions (step, trajectory) per batched product of the plain version,
# so the (chunk, K, d, d) intermediates stay bounded
_PLAIN_CHUNK = 200

_PRECISIONS = ("highest", "high")

# (step, group) items per kernel launch.  Every item is independent, but on
# a long time grid the persistent blocks drift out of step and the time per
# item grows (on an H100 at d = 100 one launch of 16000 items took 522 ms,
# one of 2000 items 49 ms), so the wrapper launches one window of steps at
# a time, about eight rounds of the grid each.
_ITEMS_PER_LAUNCH = 2048


def _frechet_trace_plain(H0, ops, coeffs, dts, psis, chis, n_squarings):
    """Plain traces for grouped inputs (``H0 (G, d, d)``, ``K = G·gs``)."""
    cdtype = psis.dtype
    N_T, K, d = psis.shape
    G, T = ops.shape[0], ops.shape[1]
    gs = _group_size(K, G)
    s = int(n_squarings)
    scale = 2.0 ** (-s)
    trj = torch.empty((N_T, K, T), dtype=cdtype, device=psis.device)
    chunk = max(1, _PLAIN_CHUNK // K)
    for c0 in range(0, N_T, chunk):
        sl = slice(c0, c0 + chunk)
        co, dt = _window(coeffs, dts, c0, c0 + chunk)
        co = co.to(cdtype)
        if co.ndim == 3:
            H = H0[None] + torch.einsum("gnt,gtij->ngij", co, ops)
        else:
            H = H0[None] + torch.einsum("nt,gtij->ngij", co, ops)
        A = (-1j * dt.to(cdtype) * scale)[:, None, None, None] * H
        # rank-1 direction R[b, a] = ψ_b conj(χ_a), scaled by 2^-s
        R = scale * torch.einsum("nkb,nka->nkba", psis[sl], chis[sl].conj())
        E, L = _frechet_taylor_ps(A, R.reshape(-1, G, gs, d, d))
        for _ in range(s):
            Eb = E[..., None, :, :]
            E, L = E @ E, Eb @ L + L @ Eb
        trj[sl] = torch.einsum("gtab,ngjba->ngjt", ops, L).reshape(-1, K, T)
    return trj


def _frechet_trace(name, H0, ops, coeffs, dts, psis, chis, n_squarings,
                   precision):
    """The traces of wrapper ``name`` on grouped inputs."""
    _require(precision in _PRECISIONS, f"unknown precision {precision!r}")
    if psis.device.type == "cpu" or plain_forced():
        return _frechet_trace_plain(H0, ops, coeffs, dts, psis, chis,
                                    n_squarings)
    G, T, d, N_T, stride = _check_group_args(H0, ops, coeffs, dts)
    device = H0.device
    K = psis.shape[1]
    gs = _group_size(K, G)
    _check_tensor("psis", psis, torch.complex64, (N_T, K, d), device)
    _check_tensor("chis", chis, torch.complex64, (N_T, K, d), device)
    s = _squarings(n_squarings)
    lib = load_kernels()
    C = max(1, min(N_T, _ITEMS_PER_LAUNCH // G))  # steps per launch
    n_blocks = _grid_blocks(device, C * G)
    n_mat = lib.grape_frechet_scratch_matrices(s)
    trj = torch.empty((N_T, K, T), dtype=torch.complex64, device=device)
    scratch = torch.empty(
        (n_blocks * n_mat, d, d), dtype=torch.complex64, device=device
    )
    with torch.cuda.device(device):
        for n0 in range(0, N_T, C):
            n1 = min(n0 + C, N_T)
            co, dt = _window(coeffs, dts, n0, n1)
            check(lib, lib.grape_frechet_trace(
                H0.data_ptr(), ops.data_ptr(), co.data_ptr(), dt.data_ptr(),
                psis[n0:n1].data_ptr(), chis[n0:n1].data_ptr(), T, d,
                n1 - n0, K, G, gs, (n1 - n0) * T if stride else 0, s,
                scratch.data_ptr(), n_blocks, trj[n0:n1].data_ptr(),
                _stream(device),
            ), "Frechet trace kernel launch")
    launches[name] += 1
    return trj


def frechet_trace_shared_plain(H0, ops, coeffs, dts, psis, chis, n_squarings,
                               precision="high"):
    """Plain PyTorch version of :func:`frechet_trace_shared` (same Taylor
    degree, same static ``s``, same pair doublings), in chunks of about
    ``_PLAIN_CHUNK`` directions."""
    _require(precision in _PRECISIONS, f"unknown precision {precision!r}")
    return _frechet_trace_plain(H0[None], ops[None], coeffs, dts, psis, chis,
                                n_squarings)


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
    _require(H0.ndim == 2 and ops.ndim == 3 and coeffs.ndim == 2,
             "H0 must be (d, d), ops (T, d, d) and coeffs (N_T, T)")
    return _frechet_trace("frechet_trace_shared", H0[None], ops[None],
                          coeffs, dts, psis, chis, n_squarings, precision)


def frechet_trace_pertraj_plain(H0, ops, coeffs, dts, psis, chis,
                                n_squarings, precision="high", group_size=1):
    """Plain PyTorch version of :func:`frechet_trace_pertraj`."""
    _require(precision in _PRECISIONS, f"unknown precision {precision!r}")
    _require(H0.shape[0] * int(group_size) == psis.shape[1],
             "psis must hold group_size trajectories per generator")
    return _frechet_trace_plain(H0, ops, coeffs, dts, psis, chis,
                                n_squarings)


def frechet_trace_pertraj(H0, ops, coeffs, dts, psis, chis, n_squarings,
                          precision="high", group_size=1):
    """``trj[n, k, t] = tr(Op_gt · L(-i dt_n H_ng, ψ_nk χ_nk†))`` with one
    generator per trajectory (``group_size=1``) or per group of
    ``group_size`` contiguous trajectories; the expm base is formed once
    per (step, group) and shared by the group's directions.

    Args:
      H0:   (G, d, d) complex64, ``G = K / group_size``
      ops:  (G, T, d, d) complex64
      coeffs: (N_T, T) float32 shared, or (G, N_T, T) one table per group
      dts:  (N_T,) float32
      psis, chis: (N_T, K, d) complex64
      n_squarings: squaring count ``s`` (runtime integer)

    Returns trj (N_T, K, T) complex64.
    """
    _require(H0.shape[0] * int(group_size) == psis.shape[1],
             "psis must hold group_size trajectories per generator")
    return _frechet_trace("frechet_trace_pertraj", H0, ops, coeffs, dts,
                          psis, chis, n_squarings, precision)
