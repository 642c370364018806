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
``n``.  Two kernels compute it, both with the rows of ``H̃_n`` split over a
co-resident grid, one CTA per SM; :func:`cheby_route` picks one:

- ``"ring"`` (``csrc/cheby_ring.cu``): no grid-wide barrier.  Each new
  vector of the series goes from its rows' owner to a ring of two global
  slots behind a release flag, and a consumer warp waits only on the flags
  of the columns it reads; the next step's rows are formed by a warp of
  their own into a second shared buffer while the terms run; the owner's
  running sum and last two vectors stay in shared memory; a warp's tile of
  rows × trajectories keeps its sums in registers.  It takes ``d`` up to 8
  rows per SM (1056 on 132 SMs) where its buffers fit shared memory;
- ``"grid"`` (``csrc/cheby_scan.cu``): one grid-wide barrier per term, the
  state restaged from L2 behind each; the route above the ring's limits.

The wrapper launches a kernel for CUDA tensors (or raises) and runs the
plain version only for CPU tensors; ``launches`` counts the calls that
launched, ``launches_by_direction`` the same calls by direction and
``route_launches`` the launches of each kernel, ``terms`` the series work
of every call (terms × steps × states).  The kernels take complex64
only (full float32 FMAs).  The TPU's budget helper
``cheby_stream_row_blocks`` has no counterpart: no VMEM budget applies here.
"""

import contextlib
import ctypes

import numpy as np
import torch

from . import plain_forced
from ._build import check, load_kernels
from .cheby import cheby_apply
from .hopper_prop import _check_tensor, _require, _sm_count, _stream

__all__ = [
    "cheby_scan", "cheby_scan_plain", "cheby_scan_layout", "cheby_route",
    "CHEBY_MAX_DIM", "launches", "launches_by_direction", "route_launches",
    "terms",
]

# wrapper calls that launched a kernel
launches = {"cheby_scan": 0}
launches_by_direction = {"forward": 0, "adjoint": 0}
# kernel launches per route: the ring kernel, the grid-barrier kernel
route_launches = {"cheby_ring": 0, "cheby_grid": 0}
# the series work of the calls: Σ terms (the table's width, padded terms
# included) × steps × states, launched or, for CPU tensors, in the plain
# version
terms = {"cheby_scan": 0}

# the route forced for checks and timings (see _forced_route)
_forced = {"route": None}

# shared memory one block may use on sm_90, in bytes
_SMEM_MAX = 232448
# multiprocessors of one H100 SXM: the card the rule assumes on the CPU
H100_SMS = 132
# most rows of H̃_n one CTA of the ring kernel owns (its register tile)
RING_MAX_ROWS = 8
# compute warps of a ring CTA (csrc/cheby_ring.cu kComputeWarps)
RING_WARPS = 8
# unsigned ints per flag of the flag exchange: one flag per 128-byte line
# (csrc/cheby_ring.cu kFlagStride)
RING_FLAG_STRIDE = 32
# global slots of the vectors in flight: enough, since a block writes
# vector e + 2 only after reading vector e + 1 from every block, each of
# which had finished reading vector e (csrc/cheby_ring.cu)
RING_SLOTS = 2

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


def _ceil_div(a, b):
    return -(-int(a) // int(b))


def _ring_smem(d, K, rows, tr, tk):
    """Shared bytes of one ring CTA: 128 for its four mbarriers, two
    buffers of ``tr`` rows of ``H̃_n`` in split real / imaginary planes, the
    slab's running sum and last two vectors ``(K, rows)`` and two fold
    buffers of a ``tr × tk`` tile per compute warp (``csrc/cheby_ring.cu``
    ``ring_smem_bytes``)."""
    return 128 + 16 * tr * d + 24 * K * rows + 16 * RING_WARPS * tr * tk


def cheby_route(d, K, sm_count=H100_SMS):
    """The kernel and layout of the Chebyshev scan at ``(d, K)`` on a card
    of ``sm_count`` SMs: ``{"route", "rows", "blocks", "tr", "tk", "wk",
    "wj", "chunks", "smem"}``.

    One CTA per SM owns ``rows = ⌈d / sm_count⌉`` rows of ``H̃_n``
    (``blocks = ⌈d / rows⌉`` CTAs).  A ring CTA's eight compute warps each
    hold a tile of ``tr`` rows (2, 4 or 8, ≥ rows) × ``tk`` trajectories
    (1 at K = 1, else 4: a tile of 8 × 8 sums spills at the register cap
    of the 288-thread block and ran slower) of register sums; ``wk`` warps (a power of two ≤ 8) split the
    trajectories, ``wj = 8 / wk`` the columns, and K beyond ``tk · wk``
    runs in ``chunks``.  ``"ring"``
    where ``rows ≤ 8`` and its shared memory fits one CTA, else ``"grid"``
    (the grid-barrier kernel, which tiles the state and takes d up to
    ``CHEBY_MAX_DIM``).  The same rule on the CPU and on the card."""
    d, K, sms = int(d), int(K), int(sm_count)
    _require(d >= 1 and K >= 1 and sms >= 1,
             f"no Chebyshev layout for d={d}, K={K} on {sms} SMs")
    rows = _ceil_div(d, sms)
    tr = 2 if rows <= 2 else 4 if rows <= 4 else 8
    tk = 1 if K == 1 else 4
    groups = _ceil_div(K, tk)
    wk = 1
    while wk < min(RING_WARPS, groups):
        wk *= 2
    smem = _ring_smem(d, K, rows, tr, tk)
    fits = rows <= RING_MAX_ROWS and smem <= _SMEM_MAX
    return {"route": "ring" if fits else "grid", "rows": rows,
            "blocks": _ceil_div(d, rows), "tr": tr, "tk": tk, "wk": wk,
            "wj": RING_WARPS // wk, "chunks": _ceil_div(K, tk * wk),
            "smem": smem}


@contextlib.contextmanager
def _forced_route(route):
    """Within the block :func:`cheby_scan` takes ``route``, ``"ring"`` or
    ``"grid"`` (checks and timings of ``chip_smoke.py``; nothing in the
    package uses it)."""
    old = _forced["route"]
    _forced["route"] = route
    try:
        yield
    finally:
        _forced["route"] = old


def cheby_scan_layout(d, K):
    """``{"rows", "blocks", "tile_k", "smem_bytes"}`` of the grid-barrier
    kernel at ``(d, K)`` on the current CUDA device: rows of ``H̃_n`` per block,
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
    ``adjoint`` the co-states entering each step.  The kernel is
    :func:`cheby_route`'s.  A grid that the card cannot hold at once raises;
    it is never launched.
    """
    if psi0.device.type == "cpu" or plain_forced():
        terms["cheby_scan"] += tab.shape[1] * coeffs.shape[0] * psi0.shape[0]
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
    out = torch.empty((N_T, K, d), dtype=torch.complex64, device=device)
    plan = cheby_route(d, K, _sm_count(device))
    route = _forced["route"] or plan["route"]
    lib = load_kernels()
    inv_dE = float(np.float32(1.0 / float(dE)))
    if route == "ring":
        _require(plan["route"] == "ring",
                 f"the ring kernel does not take d={d}, K={K}: {plan}")
        ring = torch.empty((RING_SLOTS, K, d), dtype=torch.complex64,
                           device=device)
        flags = torch.zeros(plan["blocks"] * plan["wk"] * RING_FLAG_STRIDE,
                            dtype=torch.int32, device=device)
        with torch.cuda.device(device):
            check(lib, lib.grape_cheby_ring(
                planes.data_ptr(), coeffs.data_ptr(), tab.data_ptr(),
                ph.data_ptr(), float(shift), inv_dE, psi0.data_ptr(), T, d,
                K, N_T, n_cheby, int(bool(adjoint)), plan["rows"],
                plan["tr"], plan["tk"], plan["wk"], plan["chunks"],
                plan["smem"], ring.data_ptr(), flags.data_ptr(),
                out.data_ptr(), _stream(device),
            ), "Chebyshev ring kernel launch")
        route_launches["cheby_ring"] += 1
    else:
        _require(route == "grid", f"unknown Chebyshev route {route!r}")
        scratch = torch.empty((3, K, d), dtype=torch.complex64,
                              device=device)
        with torch.cuda.device(device):
            check(lib, lib.grape_cheby_scan(
                planes.data_ptr(), coeffs.data_ptr(), tab.data_ptr(),
                ph.data_ptr(), float(shift), inv_dE, psi0.data_ptr(), T, d,
                K, N_T, n_cheby, int(bool(adjoint)), scratch.data_ptr(),
                out.data_ptr(), _stream(device),
            ), "Chebyshev scan kernel launch")
        route_launches["cheby_grid"] += 1
    launches["cheby_scan"] += 1
    terms["cheby_scan"] += n_cheby * N_T * K
    launches_by_direction["adjoint" if adjoint else "forward"] += 1
    return out
