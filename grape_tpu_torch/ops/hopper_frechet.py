"""Fused rank-1 Fréchet-trace gradient: CUDA kernels, wrappers and plain
PyTorch versions.

Counterpart of ``grape_tpu/ops/pallas_frechet.py``:
:func:`frechet_trace_shared` replaces ``frechet_trace_pallas_shared`` and
:func:`frechet_trace_pertraj` replaces ``frechet_trace_pallas_pertraj``
(one generator per trajectory, or per group of ``group_size`` contiguous
trajectories; coefficient tables shared or per group):

    trj[n, k, t] = tr(Op_gt · L(−i·dt_n·H_ng, ψ_nk χ_nk†)),   g = k // gs

with the degree-16 Taylor polynomial at ``A/2^s`` and ``s`` pair doublings.
Two algorithms compute it, each one kernel for both wrappers (the shared
generator is the single group), and the wrapper takes, per call, the one
that needs fewer operations for ``(d, T, gs, s)`` (:func:`frechet_route`,
the same rule for the kernels and for the plain versions):

- ``"dense"`` (``csrc/frechet_trace.cu``): per (step, group) the powers of
  A and the E history, per direction the M-chain, the Horner recursion and
  the doublings as d×d products, then ``T`` trace reductions;
- ``"factored"`` (``csrc/frechet_factored.cu``): the direction has rank
  one, so ``L_0 = Σ_{i+j≤15} c_{i+j+1} Aⁱ R Aʲ = Σ_i u_i y_i†`` with
  ``u_i = Aⁱ 2^-s ψ``, ``y_i = Σ_j c_{i+j+1} (A†)ʲ χ``, and after the
  doublings ``L_s = Σ_{p<2^s} Eᵖ L_0 E^{2^s−1−p}``, E the same polynomial:
  two Krylov sets of matrix-vector products, extended by E, and the traces
  ``Σ_ab Op_t[a,b] Z[b,a]`` of ``Z = Σ_r x_r w_r†``, rank ``16·2^s``.  At
  ``s = 1`` E is never formed (the Krylov extension): both sets run on to
  degree 31 and ``E u_i = Σ_{k≤16} c_k u_{i+k}``,
  ``E† y_i = Σ_m D[i, m] v_m`` (:func:`_ext_tables`); at ``s ≥ 2`` E is
  formed by six dense products and applies ``2^s − 1`` times a block.

The ``(K, d, d)`` Fréchet factors never reach device memory as an output.

The TPU kernel's default ``precision="high"`` is an emulated 3-pass bf16
product, acceptable there because each step is independent.  Both kernels
use full float32 FMAs, which is at least as accurate; ``precision`` is
accepted as ``"highest"`` or ``"high"`` and both mean that arithmetic.
There is no K-blocking and no lane padding here: a group's directions are a
loop inside the block.  Nor do the TPU kernel's gates on ``d`` (16..128), on
the size of a per-group coefficient table or on the padded output carry
over.
"""

import ctypes

import torch

from . import plain_forced
from ._build import check, load_kernels
from .expm import _FACT_INV, expm_taylor_ps
from .frechet import _frechet_taylor_ps
from .hopper_prop import (
    _check_group_args, _check_tensor, _grid_blocks, _group_size, _require,
    _squarings, _stream, _window,
)

__all__ = [
    "frechet_trace_shared", "frechet_trace_shared_plain",
    "frechet_trace_pertraj", "frechet_trace_pertraj_plain",
    "frechet_flops", "frechet_route", "launches", "krylov_extension_calls",
]

# wrapper calls that launched a kernel, per wrapper and route: the dense
# kernel under the wrapper's name, the factored one with "_factored"
launches = {
    "frechet_trace_shared": 0, "frechet_trace_pertraj": 0,
    "frechet_trace_shared_factored": 0, "frechet_trace_pertraj_factored": 0,
}

# wrapper calls routed to the factored algorithm at s == EXTENSION_S (the
# kernel or, on CPU tensors, the plain version), which form the doubling's
# blocks by the Krylov extension
krylov_extension_calls = 0

# directions (step, trajectory) per batched product of the plain versions,
# so the (chunk, K, d, d) intermediates stay bounded
_PLAIN_CHUNK = 200

_PRECISIONS = ("highest", "high")

# (step, group) items per launch of the dense kernel.  Its persistent
# blocks drift out of step on a long time grid and its time per item grows
# (on an H100 at d = 100 one launch of 16000 items took 522 ms, one of 2000
# items 49 ms), so it runs one window of steps at a time, about eight
# rounds of its grid each.  The factored kernel keeps its working set in
# shared memory and takes the whole grid in one launch.
_ITEMS_PER_LAUNCH = 2048

# vectors per Krylov set of the factored algorithm (degree 16)
_SET = 16

# the doublings whose blocks the factored algorithm forms from the Krylov
# sets carried on to degree 2·_SET − 1 instead of from E (the kernel's
# kExtS); past it the Krylov vectors would grow as ‖A‖ʲ
EXTENSION_S = 1


def frechet_flops(d, T, gs, s):
    """Float32 operations per (step, group) item of each algorithm,
    ``{"dense": ..., "factored": ...}``, for a group of ``gs`` directions,
    ``T`` control terms and ``s`` doublings (complex products counted as 8
    operations a multiply-add).

    Both build ``A_n`` (``(4T + 2)·d²``).  Dense: ``5 + s`` products for the
    base and the ladder, per direction ``12 + 2s`` products and ``T``
    traces.  Factored: per direction 30 matrix-vector products for the two
    Krylov sets, ``32·(2^s − 1)`` more to extend them, the real-by-complex
    multiply-adds of the folds (136 for ``y_i = Σ_j c_{i+j+1} v_j``, and at
    ``s = EXTENSION_S`` 16·17 for ``E u_i = Σ_k c_k u_{i+k}`` and the 392
    nonzero entries of D), ``16·2^s`` outer products into ``Z`` and ``T``
    traces; the extension is by E, six products an item, where
    ``s > EXTENSION_S``, and at ``s = EXTENSION_S`` by carrying the Krylov
    sets on, with no dense product."""
    s = int(s)
    mv = 8.0 * d * d
    cmm = 8.0 * d ** 3
    gen = (4.0 * T + 2.0) * d * d
    nb = 2 ** s
    dense = gen + (5 + s) * cmm + gs * ((12 + 2 * s) * cmm + T * mv)
    folds = 136 + (16 * 17 + 392 if s == EXTENSION_S else 0)
    factored = gen + (6 * cmm if s > EXTENSION_S else 0.0) + gs * (
        (30 + 32 * (nb - 1) + _SET * nb + T) * mv + 4.0 * folds * d
    )
    return {"dense": dense, "factored": factored}


def frechet_route(d, T, gs, s):
    """The algorithm with fewer operations for these integers (ties:
    dense).  The wrappers take it for CUDA and for CPU tensors alike."""
    f = frechet_flops(d, T, gs, s)
    return "factored" if f["factored"] < f["dense"] else "dense"


def _hankel(cdtype, device):
    """``C[i, j] = c_{i+j+1} = 1/(i+j+1)!`` for ``i + j ≤ 15``, else 0."""
    C = torch.zeros((_SET, _SET), dtype=torch.float64)
    for i in range(_SET):
        for j in range(_SET - i):
            C[i, j] = _FACT_INV[i + j + 1]
    return C.to(device=device, dtype=cdtype)


def _ext_tables(cdtype, device):
    """The folds of the Krylov extension, ``(Cx, D)`` of shape (16, 32):
    ``E u_i = Σ_m Cx[i, m] u_m`` with ``Cx[i, i+k] = c_k`` (``k ≤ 16``) and
    ``E† y_i = Σ_m D[i, m] v_m`` with
    ``D[i, m] = Σ_{j+k=m, j≤15−i, k≤16} c_{i+j+1} c_k``."""
    Cx = torch.zeros((_SET, 2 * _SET), dtype=torch.float64)
    D = torch.zeros((_SET, 2 * _SET), dtype=torch.float64)
    for i in range(_SET):
        for k in range(_SET + 1):
            Cx[i, i + k] = _FACT_INV[k]
        for j in range(_SET - i):
            for k in range(_SET + 1):
                D[i, j + k] += _FACT_INV[i + j + 1] * _FACT_INV[k]
    return (Cx.to(device=device, dtype=cdtype),
            D.to(device=device, dtype=cdtype))


def _plain_generators(H0, ops, coeffs, dts, sl, scale, cdtype):
    """``A (n, G, d, d) = −i·dt·2^-s·(H0 + Σ_t c_t Op_t)`` on steps ``sl``."""
    co, dt = _window(coeffs, dts, sl.start, sl.stop)
    co = co.to(cdtype)
    if co.ndim == 3:
        H = H0[None] + torch.einsum("gnt,gtij->ngij", co, ops)
    else:
        H = H0[None] + torch.einsum("nt,gtij->ngij", co, ops)
    return (-1j * dt.to(cdtype) * scale)[:, None, None, None] * H


def _frechet_trace_plain(H0, ops, coeffs, dts, psis, chis, n_squarings):
    """Plain dense traces for grouped inputs (``H0 (G, d, d)``,
    ``K = G·gs``)."""
    cdtype = psis.dtype
    N_T, K, d = psis.shape
    G, T = ops.shape[0], ops.shape[1]
    gs = _group_size(K, G)
    s = int(n_squarings)
    scale = 2.0 ** (-s)
    trj = torch.empty((N_T, K, T), dtype=cdtype, device=psis.device)
    chunk = max(1, _PLAIN_CHUNK // K)
    for c0 in range(0, N_T, chunk):
        sl = slice(c0, min(c0 + chunk, N_T))
        A = _plain_generators(H0, ops, coeffs, dts, sl, scale, cdtype)
        # rank-1 direction R[b, a] = ψ_b conj(χ_a), scaled by 2^-s
        R = scale * torch.einsum("nkb,nka->nkba", psis[sl], chis[sl].conj())
        E, L = _frechet_taylor_ps(A, R.reshape(-1, G, gs, d, d))
        for _ in range(s):
            Eb = E[..., None, :, :]
            E, L = E @ E, Eb @ L + L @ Eb
        trj[sl] = torch.einsum("gtab,ngjba->ngjt", ops, L).reshape(-1, K, T)
    return trj


def _frechet_trace_factored_plain(H0, ops, coeffs, dts, psis, chis,
                                  n_squarings):
    """Plain factored traces for grouped inputs: the kernel's Krylov sets
    ``u_i = Aⁱ 2^-s ψ`` and ``v_j = (A†)ʲ χ``, the fold
    ``y_i = Σ_j c_{i+j+1} v_j``, the extension by ``E`` (block ``p`` of
    the x set is ``Eᵖ u``, block ``q`` of the w set ``(E†)^q y``), and
    ``tr(Op_t Z)`` with ``Z[b, a] = Σ_{p,i} x_{p,i}[b] conj(w_{Q−p,i}[a])``,
    ``Q = 2^s − 1``.  At ``s = EXTENSION_S`` block 1 comes from the sets
    carried on to degree 31, folded by :func:`_ext_tables`."""
    cdtype = psis.dtype
    N_T, K, d = psis.shape
    G, T = ops.shape[0], ops.shape[1]
    gs = _group_size(K, G)
    s = int(n_squarings)
    ext = s == EXTENSION_S
    scale = 2.0 ** (-s)
    C = _hankel(cdtype, psis.device)
    if ext:
        Cx, D = _ext_tables(cdtype, psis.device)
    trj = torch.empty((N_T, K, T), dtype=cdtype, device=psis.device)
    chunk = max(1, _PLAIN_CHUNK // K)
    for c0 in range(0, N_T, chunk):
        sl = slice(c0, min(c0 + chunk, N_T))
        A = _plain_generators(H0, ops, coeffs, dts, sl, scale, cdtype)
        Ab = A[:, :, None]   # (n, G, 1, d, d)
        AHb = Ab.mH
        u = scale * psis[sl].reshape(-1, G, gs, d, 1)
        v = chis[sl].reshape(-1, G, gs, d, 1)
        us, vs = [u], [v]
        for _ in range((2 if ext else 1) * _SET - 1):
            us.append(Ab @ us[-1])
            vs.append(AHb @ vs[-1])
        U = torch.cat(us, dim=-1)   # (n, G, gs, d, 16 or 32): u_i
        V = torch.cat(vs, dim=-1)
        X = U[..., :_SET]
        Y = V[..., :_SET] @ C.T     # column i = y_i = Σ_j C[i, j] v_j
        xs, ws = [X], [Y]
        if ext:
            xs.append(U @ Cx.T)     # E u_i
            ws.append(V @ D.T)      # E† y_i
        elif s:
            Eb = expm_taylor_ps(A)[:, :, None]
            for _ in range((1 << s) - 1):
                xs.append(Eb @ xs[-1])
                ws.append(Eb.mH @ ws[-1])
        X = torch.cat(xs, dim=-1)          # blocks p = 0..Q
        W = torch.cat(ws[::-1], dim=-1)    # blocks Q - p, paired with p
        Z = X @ W.mH                       # Z[b, a]
        trj[sl] = torch.einsum("gtab,ngjba->ngjt", ops, Z).reshape(-1, K, T)
    return trj


_PLAIN = {"dense": _frechet_trace_plain,
          "factored": _frechet_trace_factored_plain}


def _launch_dense(lib, args, G, T, d, N_T, K, gs, stride, s, device, trj):
    H0, ops, coeffs, dts, psis, chis = args
    C = max(1, min(N_T, _ITEMS_PER_LAUNCH // G))  # steps a launch
    n_blocks = _grid_blocks(device, C * G)
    n_mat = lib.grape_frechet_scratch_matrices(s)
    scratch = torch.empty(
        (n_blocks * n_mat, d, d), dtype=torch.complex64, device=device
    )
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


def factored_plan(d, T, gs, s, n_items):
    """The factored kernel's layout on the current CUDA device:
    ``{"chunk", "matrix_shared", "sets_shared", "smem_bytes", "blocks",
    "scratch_floats"}`` (directions side by side, where the matrix and the
    sets live, dynamic shared memory, the resident grid, global scratch per
    block)."""
    lib = load_kernels()
    out = (ctypes.c_int * 5)()
    floats = ctypes.c_longlong()
    check(lib, lib.grape_frechet_factored_plan(
        d, T, gs, s, n_items, out, ctypes.byref(floats)
    ), "Frechet factored kernel plan")
    return {"chunk": out[0], "matrix_shared": bool(out[1]),
            "sets_shared": bool(out[2]), "smem_bytes": out[3],
            "blocks": out[4], "scratch_floats": floats.value}


def _launch_factored(lib, args, G, T, d, N_T, K, gs, stride, s, device,
                     trj):
    H0, ops, coeffs, dts, psis, chis = args
    plan = factored_plan(d, T, gs, s, N_T * G)
    scratch = torch.empty(
        max(1, plan["blocks"] * plan["scratch_floats"]), dtype=torch.float32,
        device=device,
    )
    check(lib, lib.grape_frechet_factored(
        H0.data_ptr(), ops.data_ptr(), coeffs.data_ptr(), dts.data_ptr(),
        psis.data_ptr(), chis.data_ptr(), T, d, N_T, K, G, gs, stride, s,
        plan["chunk"], int(plan["matrix_shared"]), int(plan["sets_shared"]),
        plan["smem_bytes"], scratch.data_ptr(), plan["scratch_floats"],
        plan["blocks"], trj.data_ptr(), _stream(device),
    ), "Frechet factored kernel launch")


def _frechet_trace(name, H0, ops, coeffs, dts, psis, chis, n_squarings,
                   precision="high", route=None):
    """The traces of wrapper ``name`` on grouped inputs (``H0 (G, d, d)``,
    ``ops (G, T, d, d)``) by ``route``, ``"dense"`` or ``"factored"``
    (``None``: :func:`frechet_route`, as the wrappers call it; a route is
    forced only to check or time one kernel against the other)."""
    global krylov_extension_calls
    _require(precision in _PRECISIONS, f"unknown precision {precision!r}")
    s = _squarings(n_squarings)
    G, T, d = ops.shape[0], ops.shape[1], ops.shape[-1]
    gs = _group_size(psis.shape[1], G)
    if route is None:
        route = frechet_route(d, T, gs, s)
    _require(route in _PLAIN, f"unknown route {route!r}")
    if route == "factored" and s == EXTENSION_S:
        krylov_extension_calls += 1
    if psis.device.type == "cpu" or plain_forced():
        return _PLAIN[route](H0, ops, coeffs, dts, psis, chis, s)
    G, T, d, N_T, stride = _check_group_args(H0, ops, coeffs, dts)
    device = H0.device
    K = psis.shape[1]
    _check_tensor("psis", psis, torch.complex64, (N_T, K, d), device)
    _check_tensor("chis", chis, torch.complex64, (N_T, K, d), device)
    lib = load_kernels()
    trj = torch.empty((N_T, K, T), dtype=torch.complex64, device=device)
    launch = _launch_factored if route == "factored" else _launch_dense
    with torch.cuda.device(device):
        launch(lib, (H0, ops, coeffs, dts, psis, chis), G, T, d, N_T, K, gs,
               stride, s, device, trj)
    launches[name + ("_factored" if route == "factored" else "")] += 1
    return trj


def frechet_trace_shared_plain(H0, ops, coeffs, dts, psis, chis, n_squarings,
                               precision="high"):
    """Plain PyTorch version of :func:`frechet_trace_shared` (same Taylor
    degree, same static ``s``, same pair doublings, the algorithm
    :func:`frechet_route` picks), in chunks of about ``_PLAIN_CHUNK``
    directions."""
    _require(precision in _PRECISIONS, f"unknown precision {precision!r}")
    s = _squarings(n_squarings)
    route = frechet_route(ops.shape[-1], ops.shape[0], psis.shape[1], s)
    return _PLAIN[route](H0[None], ops[None], coeffs, dts, psis, chis, s)


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
    s = _squarings(n_squarings)
    route = frechet_route(ops.shape[-1], ops.shape[1], int(group_size), s)
    return _PLAIN[route](H0, ops, coeffs, dts, psis, chis, s)


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
