"""Chebyshev propagation scan: the CUDA kernel, its wrapper and its plain
PyTorch version.

:func:`cheby_scan` replaces both TPU kernels of the Chebyshev regime,
``cheby_scan_pallas_shared`` (``grape_tpu/ops/pallas_prop.py:956``) and
``cheby_scan_pallas_stream`` (``:1183``), which compute one function and
differ only in how the TPU holds the operator planes.  One generator shared
by K trajectories: per step ``H_n = H0 + Σ_t c[n,t]·Op_t``, the normalised
``H̃_n = (2H_n − shift·I)/dE``, the ``n_cheby``-term recursion
``φ_{m+1} = 2H̃_nφ_m − φ_{m−1}`` on the ``(K, d)`` state block,
``acc = Σ_m tab[n,m]·φ_m`` and the new state ``ph[n]·acc``.  With
``adjoint`` the time axis runs backwards under ``H̃_n = (2H_n† − shift·I)/dE``
and row ``n`` of the output is the state ENTERING step ``n``
(``chis[n] = χ(t_{n+1})``); forward, row ``n`` is the state after step
``n``.  The kernel is ``csrc/cheby_scan.cu``: the rows of ``H̃_n`` split over
a co-resident grid, one grid-wide barrier per term.

The wrapper launches the kernel for CUDA tensors (or raises) and runs the
plain version only for CPU tensors; ``launches`` counts the calls that
launched, ``launches_by_direction`` the same calls by direction.  The kernel
takes complex64 only (full float32 FMAs).  The TPU's budget helper
``cheby_stream_row_blocks`` has no counterpart: no VMEM budget applies here.
"""

import ctypes

import numpy as np
import torch

from . import plain_forced
from ._build import check, load_kernels
from .cheby import cheby_apply
from .hopper_prop import _check_tensor, _require, _stream

__all__ = [
    "cheby_scan", "cheby_scan_plain", "cheby_scan_layout", "CHEBY_MAX_DIM",
    "launches", "launches_by_direction",
]

# wrapper calls that launched the kernel
launches = {"cheby_scan": 0}
launches_by_direction = {"forward": 0, "adjoint": 0}

# largest dimension the kernel is routed to: a block holds its rows of H_n
# and a tile of the state in shared memory (227 KB), which fits up to about
# d = 1850 on 132 multiprocessors; this bound (above the reference's own
# ceiling, d ≈ 1478) leaves room for cards with fewer
CHEBY_MAX_DIM = 1536


def cheby_scan_plain(H0, ops, coeffs, tab, ph, shift, dE, psi0,
                     adjoint=False):
    """Plain PyTorch version of :func:`cheby_scan`: step by step, term by
    term (padded table terms included), the same normalisation."""
    N_T = coeffs.shape[0]
    d = psi0.shape[-1]
    cdt = psi0.dtype
    co = coeffs.to(cdt)
    eye = torch.eye(d, dtype=cdt, device=psi0.device)
    rows = tab.tolist()
    phases = ph.tolist()
    out = torch.empty((N_T,) + tuple(psi0.shape), dtype=cdt,
                      device=psi0.device)
    psi = psi0
    for n in (range(N_T - 1, -1, -1) if adjoint else range(N_T)):
        H = H0 + torch.einsum("t,tij->ij", co[n], ops)
        if adjoint:
            H = H.conj().transpose(-1, -2)
            out[n] = psi
        HnT = ((2.0 * H - shift * eye) / dE).transpose(-1, -2)
        psi = cheby_apply(lambda v: v @ HnT, psi, rows[n], phases[n])
        if not adjoint:
            out[n] = psi
    return out


def cheby_scan_layout(d, K):
    """``{"rows", "blocks", "tile_k", "smem_bytes"}`` of the kernel's grid at
    ``(d, K)`` on the current CUDA device: rows of ``H̃_n`` per block,
    blocks, trajectories per shared tile of the state, shared bytes per
    block.  Raises where no layout fits."""
    lib = load_kernels()
    out = (ctypes.c_int * 4)()
    check(lib, lib.grape_cheby_scan_layout(int(d), int(K), out),
          f"Chebyshev scan layout at d={d}, K={K}")
    return dict(zip(("rows", "blocks", "tile_k", "smem_bytes"), list(out)))


def cheby_scan(H0, ops, coeffs, tab, ph, shift, dE, psi0, adjoint=False):
    """Chebyshev propagation scan for a SHARED generator.

    Args:
      H0:   (d, d) complex64 drift
      ops:  (T, d, d) complex64 control-term operators
      coeffs: (N_T, T) float32 per-step term coefficients
      tab:  (N_T, n_cheby) complex64 per-step Chebyshev coefficients, rows
        padded with zeros to one width, ``n_cheby ≥ 2``
      ph:   (N_T,) complex64 per-step overall phases
      shift, dE: the spectral normalisation (Python floats)
      psi0: (K, d) complex64 initial states (``adjoint``: χ(T))
      adjoint: propagate ``exp(+i dt H†)`` down the time axis

    Returns ``(N_T, K, d)`` complex64: the states after each step, or with
    ``adjoint`` the co-states entering each step.  A grid that the card
    cannot hold at once raises; it is never launched.
    """
    if psi0.device.type == "cpu" or plain_forced():
        return cheby_scan_plain(H0, ops, coeffs, tab, ph, shift, dE, psi0,
                                adjoint)
    device = psi0.device
    _require(H0.ndim == 2 and ops.ndim == 3 and coeffs.ndim == 2
             and tab.ndim == 2 and psi0.ndim == 2,
             "H0 must be (d, d), ops (T, d, d), coeffs (N_T, T), "
             "tab (N_T, n_cheby) and psi0 (K, d)")
    K, d = psi0.shape
    T, N_T, n_cheby = ops.shape[0], coeffs.shape[0], tab.shape[1]
    _check_tensor("H0", H0, torch.complex64, (d, d), device)
    _check_tensor("ops", ops, torch.complex64, (T, d, d), device)
    _check_tensor("coeffs", coeffs, torch.float32, (N_T, T), device)
    _check_tensor("tab", tab, torch.complex64, (N_T, n_cheby), device)
    _check_tensor("ph", ph, torch.complex64, (N_T,), device)
    _check_tensor("psi0", psi0, torch.complex64, (K, d), device)
    _require(N_T >= 1 and K >= 1, "need at least one step and trajectory")
    _require(n_cheby >= 2, f"need at least 2 Chebyshev terms, got {n_cheby}")
    planes = torch.cat([H0[None], ops])  # (T+1, d, d)
    if adjoint:
        # rows of H† are the conjugated columns of H: read contiguously
        planes = torch.conj_physical(planes.transpose(-1, -2).contiguous())
    scratch = torch.empty((3, K, d), dtype=torch.complex64, device=device)
    out = torch.empty((N_T, K, d), dtype=torch.complex64, device=device)
    lib = load_kernels()
    with torch.cuda.device(device):
        check(lib, lib.grape_cheby_scan(
            planes.data_ptr(), coeffs.data_ptr(), tab.data_ptr(),
            ph.data_ptr(), float(shift), float(np.float32(1.0 / float(dE))),
            psi0.data_ptr(), T, d, K, N_T, n_cheby, int(bool(adjoint)),
            scratch.data_ptr(), out.data_ptr(), _stream(device),
        ), "Chebyshev scan kernel launch")
    launches["cheby_scan"] += 1
    launches_by_direction["adjoint" if adjoint else "forward"] += 1
    return out
