"""Analytic FLOP model for the fg evaluation, the counterpart of
``grape_tpu.flops``.

Counts the algorithmic complex-arithmetic FLOPs of one
function-and-gradient evaluation from the SAME host-side path selection
``build_fg`` uses (shared-generator detection, generator groups, the
vectorized-backward gates, the static Taylor-order and squaring counts),
so a rate quoted against it reads the same work whatever implements it.

Conventions
-----------
- one complex multiply-add = 8 real FLOPs;
- a ``d×d @ d×d`` complex matmul = ``8·d³``, a matvec = ``8·d²``;
- the count is the ALGORITHMIC work (what the textbook formula costs): the
  rank-factored Fréchet kernel of the card does far less for the same
  count, so a rate quoted against this count can exceed what the kernel's
  own operations would give;
- O(d) and O(L·N_T) bookkeeping terms (coefficient tables, trapezoid
  weights, functionals) are omitted: they are ≤ 1e-3 of any entry here.

Per-path formulas (the reference's):

- ``expm`` (complex64: degree-16 Taylor-PS, ``ops/expm.py``) = A², A³, A⁴
  (3 matmuls) + 4 Horner blocks (4) = 7 matmuls, + ``s`` squarings;
  complex128: Padé-13, 9 matmul-equivalents;
- ``expm_frechet`` in ``D`` directions: base 7 + 13·D matmul-equivalents,
  each squaring 1 + 2·D;
- Chebyshev: ``n_c`` coefficient terms = ``n_c − 1`` matvecs per step;
- vectorized Taylor backward: per order ``K·(L+1)`` + ``K·T`` matvecs per
  step + the (T→L) contraction ``8·K·L·T·d`` per step.

Where the port counts other work than the reference (stated, and pinned by
the tests):

- the reference counts its TPU Fréchet kernel's blocking of a shared
  generator's K > 8 directions into padded blocks of 8, each re-deriving
  the base; the port has no such blocking and counts
  ``(7 + 13K) + s(1 + 2K)`` matmuls per step there;
- the port derives a generator group's Fréchet base once per (step, group)
  on every route (the kernels and the plain complex128 pass alike), where
  the reference does so only in its per-trajectory kernel (complex64,
  ``16 ≤ d ≤ 128``, on the TPU): for groups of ``gs > 1`` the port counts
  ``(K/gs)(7 + s) + K(13 + 2s)`` wherever the reference counts
  ``K(20 + 3s)``; on the small-d route (complex64, d ≤ 4, K ≥ 128) the
  port forms one exponential per trajectory, groups or not.
"""

import numpy as np

from . import fg as _fg

__all__ = ["fg_flops"]

_EXPM_F32_MATMULS = 7     # degree-16 Taylor-PS (see module docstring)
_EXPM_F64_MATMULS = 9     # Padé-13: A2/A4/A6 + 3 products + ~3 for the solve


def _expm_matmuls(cp):
    return (
        _EXPM_F32_MATMULS
        if np.dtype(cp.psi0.dtype) == np.complex64
        else _EXPM_F64_MATMULS
    )


def fg_flops(cp, amp_max=None):
    """Formula-derived FLOPs of ONE fg evaluation of `cp` (float)."""
    pd = _fg._prop_data(cp, amp_max)
    vec_gg = _fg._vec_gradgen_enabled(cp)
    reuse_U = _fg._reuse_U_enabled(cp) or vec_gg
    n_ord = _fg._vectorized_taylor_orders(cp, amp_max)
    vec_bw = cp.vectorize_backward and n_ord is not None
    s = _fg._static_squarings(cp, amp_max)

    d, K, L, N_T = cp.dim, cp.n_traj, cp.n_controls, cp.n_timesteps
    T = int(np.asarray(cp.M).shape[-2])
    k_u = 1 if cp.shared_generator else K
    gs = _fg._compute_group_size(cp)
    MM = 8.0 * d**3
    MV = 8.0 * d**2
    e_mm = _expm_matmuls(cp)

    def cheby_terms(pd_dir, key):
        return int(np.asarray(pd_dir[key]).shape[1])

    total = 0.0

    # ---- forward propagation -------------------------------------------
    pd_fw = pd["fw"]
    # generator groups: one exponential per (step, group)
    k_fw = k_u
    if not cp.shared_generator and pd_fw is None and gs > 1:
        k_fw = K // gs
    total += N_T * k_fw * T * MV  # H_n assembly from the T term operators
    if pd_fw is None:  # ExpProp
        total += N_T * (k_fw * (e_mm + s) * MM + K * MV)
    elif pd_fw["kind"] == "cheby":
        n_c = cheby_terms(pd_fw, "tab_fw")
        total += N_T * (n_c - 1) * K * MV
    else:  # newton/arnoldi: m substep matvecs + small-matrix expm
        m = pd_fw["m"] * pd_fw["substeps"]
        total += N_T * K * m * MV

    # ---- backward gradient ----------------------------------------------
    recompute = cp.storage_mode == "recompute"
    if recompute:
        # segment re-propagation duplicates the forward work once
        total *= 2.0

    if vec_gg:
        # phase A: the χ chain, one U†χ matvec a step over stored
        # propagators, else a per-step (grouped) adjoint expm scan;
        # phase B: one rank-1 Fréchet derivative per step and direction
        k_a = 1 if cp.shared_generator else K // gs
        u_stored = _fg._seg_reuse_U(cp) if recompute else _fg._gg_u_bytes_ok(cp)
        if u_stored:
            total += N_T * K * MV
        else:
            total += N_T * (k_a * (e_mm + s) * MM + K * MV)
        total += N_T * K * MV  # R = psi chi† outer products
        if cp.shared_generator:
            fre_mm = (7 + 13 * K) + s * (1 + 2 * K)
            total += N_T * fre_mm * MM
        else:
            if gs > 1:
                # base (7 + s) once per (n, group), Fréchet chain
                # (13 + 2s) per direction
                total += N_T * ((K // gs) * (7 + s) + K * (13 + 2 * s)) * MM
            else:
                total += N_T * K * (20 + 3 * s) * MM
            total += N_T * k_u * T * MV  # H_n reassembly
        total += N_T * K * T * MV  # tr(Op_j G) contractions
        return total

    if cp.gradient_method == "taylor" and vec_bw:
        # phase A
        pd_bw = pd["bw"]
        k_a = 1 if cp.shared_generator else K // gs
        u_avail = (
            _fg._seg_reuse_U(cp) if recompute else (reuse_U and pd_bw is None)
        )
        if u_avail and pd_bw is None:
            total += N_T * K * MV  # U† chi matvecs
        elif pd_bw is not None and pd_bw["kind"] == "cheby":
            n_c = cheby_terms(pd_bw, "tab_bw")
            total += N_T * ((n_c - 1) * K * MV + k_u * T * MV)
        else:
            total += N_T * (k_a * (e_mm + s) * MM + K * MV + k_a * T * MV)
        # phase B: n_ord orders of the batched recursion
        per_order = N_T * (
            K * (L + 1) * MV + K * T * MV + 8.0 * K * L * T * d
        )
        total += (n_ord + 1) * per_order
        total += N_T * k_u * T * MV  # H_n† assembly
        return total

    # per-step passes
    total += N_T * k_u * T * MV  # H_n reassembly in the backward scan
    if cp.gradient_method == "taylor":
        # the series' order is bounded from the envelope (the static-order
        # estimate; the per-step check stops at the same tolerance)
        orders = n_ord if n_ord is not None else cp.taylor_grad_max_order
        per_step = K * orders * ((L + 2) * MV + T * MV + 8.0 * L * T * d)
        total += N_T * per_step
        # co-state propagation
        if reuse_U:
            total += N_T * K * MV
        else:
            pd_bw = pd["bw"]
            if pd_bw is not None and pd_bw["kind"] == "cheby":
                n_c = cheby_terms(pd_bw, "tab_bw")
                total += N_T * (n_c - 1) * K * MV
            else:
                total += N_T * (k_u * (e_mm + s) * MM + K * MV)
    else:  # gradgen
        pd_g = pd["grad"]
        if pd_g is None:
            total += N_T * K * ((20 + 3 * s) * MM + (L + 1) * MV)
        elif pd_g["kind"] == "cheby":
            n_c = cheby_terms(pd_g, "tab_bw")
            # extended-state (L+1)·d matvec + L mu-injections per term
            total += N_T * (n_c - 1) * K * (2 * L + 1) * MV
        else:
            m = pd_g["m"] * pd_g["substeps"]
            total += N_T * K * m * (2 * L + 1) * MV
    return total
