"""First-order Krotov's method.

Counterpart of ``grape_tpu/krotov.py``: the second optimization method of
the package, over the same problem surface as :func:`optimize` (so that
Krotov→GRAPE and GRAPE→Krotov continuation run for real).  Per iteration:

1. the forward pass under the current pulse, storing every state and every
   step propagator (``fg._evaluate_forward`` with full storage);
2. the co-states ``χ_k(T) = -∂J_T/∂⟨Ψ_k(T)|``, NOT normalized, propagated
   backward under the current pulse over the stored propagators
   (``fg._chi_trajectory``), giving ``χ_k(t_n)``;
3. a sequential sweep: at each interval ``n`` the update
   ``Δε_l(n) = (S_l(t_n)/λ_a) · Im Σ_k ⟨χ_k(t_n)|μ_l|Ψ_k(t_n)⟩`` from the
   state already propagated under the UPDATED pulse, then one step
   ``exp(-i dt H_n)`` with ``H_n`` formed from the new value.

Routing.  The reference drops the caller's ``use_pallas`` and compiles
Krotov with ``use_pallas=False``, so its forward pass and co-state chain
are plain XLA.  The port drops the caller's value too but keeps the
default, so in complex64 on the card phases 1 and 2 run the propagator and
state-chain kernels (the shared forward scan and χ scan, the grouped or
per-trajectory scans, or the small-d kernel, by layout), exactly as an
evaluation of ``build_fg`` does; a routing choice of the port.  The
sweep is plain PyTorch, one step after another, as the reference's
``lax.scan`` is.

The sweep's exponentials take ONE squaring count per sweep (``expm`` with
``squarings=``), never a count read from the device step by step: before the
sweep one host read gets the co-state and state norms, which bound
``|Δε_l| ≤ (S_l/λ_l)·‖μ_l‖_2·Σ_k ‖χ_k‖‖Ψ_k‖`` and so the new pulse's
amplitudes ``A_l``; the count comes from the norm bound
``dt·(‖H0‖_1 + Σ_j ‖Op_j‖_1 (Σ_l |M_jl| A_l + |Mfix_j|))``.  After the sweep
the count that the new pulse's actual amplitudes need is checked against
the one taken; where it is larger (a generator that does not preserve the
norms), the sweep runs again with the amplitudes grown to the workspace's
power-of-two bucket.  One code path on the CPU and on the card.  A count
above the one a step needs moves complex128 results at rounding level only
(the tests hold the J_T series and the pulses to the reference's, which
takes each step's own count, to 1e-10 relative).

Two deliberate deviations from the reference, which keeps its faults:
``continue_from`` a result whose ``iter`` is already at ``iter_stop``
returns at once with ``converged=True`` and the message "Reached maximum
number of iterations" (the reference returns "in progress"); an
unsupported ``store_iter_info`` label raises ``ValueError`` before the loop
(the reference catches it into ``result.message``).  Limitations, each
refused by name as in the reference's scope: no state running cost
(``g_b``/``xi``), no ``CustomAmplitude``, no box bounds (Krotov's update is
unconstrained; continuation with GRAPE is the supported workflow).  The
``prop_method`` and ``storage_mode`` keywords are dropped: the sweep always
takes the exponential and needs every stored state.
"""

import datetime
import math
import time
import warnings

import numpy as np
import torch

from .controls import discretize, discretize_on_midpoints
from .fg import (
    CompiledProblem, _J_parts, _as_pulse, _chi_boundary, _chi_trajectory,
    _coeff_tables, _device_constants, _evaluate_forward, _op_norms,
    _prop_data, compile_problem,
)
from .functionals import taus
from .ops.expm import _THETA13_F64, _THETA_TAYLOR_F32, expm
from .optimize import apply_convergence_check
from .result import GrapeResult

__all__ = ["optimize_krotov", "KrotovResult"]

_LABELS = ("iter.", "J_T", "ΔJ", "ΔJ_T", "secs")

# keywords the sweep cannot honour and drops, as the reference does
_DROPPED = ("optimizer", "use_pallas", "prop_method", "fw_prop_method",
            "bw_prop_method", "grad_prop_method", "storage_mode",
            "storage_segments")


class KrotovResult(GrapeResult):
    """Result of a Krotov optimization: the protocol of
    :class:`GrapeResult` (so ``optimize(..., continue_from=kres)`` takes
    it as it is), tagged ``method = "krotov"`` so that ``io.load_result``
    reloads it as a ``KrotovResult``."""

    method = "krotov"

    def to_dict(self):
        return dict(super().to_dict(), method=self.method)


def _H_at(cp: CompiledProblem, consts, n, eps_n):
    """The generators ``H_n (G, d, d)`` of interval ``n`` for NEW pulse
    values ``eps_n (L,)`` (the sweep's updated pulse, which the old pulse's
    coefficient table does not hold)."""
    cdt = consts["cdtype"]
    if cp.per_traj_coeffs:
        c = (torch.einsum("ktl,l->kt", consts["M"][:, n], eps_n)
             + consts["Mfix"][:, n])
        return consts["H0"] + torch.einsum("kt,ktij->kij", c.to(cdt),
                                           consts["ops"])
    c = consts["M"][n] @ eps_n + consts["Mfix"][n]
    return consts["H0"] + torch.einsum("t,gtij->gij", c.to(cdt),
                                       consts["ops"])


def _sweep(cp: CompiledProblem, consts, eps, chi_start, S_lam, squarings):
    """The sequential sweep from the initial states under the updated
    pulse: ``(psi_T_new (K, d), eps_new (L, N_T))``.  ``chi_start[n]`` is
    ``χ(t_n)`` under the old pulse, ``S_lam (L, N_T)`` the update shape over
    ``λ_a``; every step's exponential takes ``squarings``."""
    cdt = consts["cdtype"]
    ops, M = consts["ops"], consts["M"]
    G, T = ops.shape[0], ops.shape[1]
    K, d = consts["psi0"].shape
    gs = K // G
    a_all = (-1j * consts["dt"]).to(cdt)
    psi = consts["psi0"].reshape(G, gs, d)
    chi_g = chi_start.reshape(-1, G, gs, d).conj()
    eps_new = torch.empty_like(eps)
    Mc = M.to(cdt)
    for n in range(cp.n_timesteps):
        # Σ_k ⟨χ_k|μ_l|ψ_k⟩ = Σ_j (∂a_j/∂ε_l) Σ_k ⟨χ_k|Op_j|ψ_k⟩
        opsv = torch.einsum("gtij,gsj->gsti", ops, psi)
        w = torch.einsum("gsi,gsti->gst", chi_g[n], opsv)
        if cp.per_traj_coeffs:
            ovl = torch.einsum("kt,ktl->l", w.reshape(K, T), Mc[:, n])
        else:
            ovl = w.reshape(-1, T).sum(0) @ Mc[n]
        eps_n = eps[:, n] + S_lam[:, n] * ovl.imag
        eps_new[:, n] = eps_n
        U = expm(a_all[n] * _H_at(cp, consts, n, eps_n), squarings=squarings)
        psi = torch.einsum("gij,gsj->gsi", U, psi)
    return psi.reshape(K, d), eps_new


def _bucket(amps):
    """The workspace's power-of-two amplitude bucket."""
    amps = np.maximum(np.asarray(amps, dtype=np.float64), 0.05)
    return np.exp2(np.ceil(np.log2(2.0 * amps)))


class _SquaringBound:
    """Host-side norm data of one problem: the squaring count for a pulse
    amplitude bound ``A (L,)``, and the bound on ``|Δε_l|`` per unit of
    ``Σ_k ‖χ_k‖‖Ψ_k‖``."""

    def __init__(self, cp: CompiledProblem, S_lam):
        single = np.dtype(cp.psi0.dtype) == np.complex64
        self.theta = _THETA_TAYLOR_F32 if single else _THETA13_F64
        self.h0, self.op1 = _op_norms(cp)
        ops = np.asarray(cp.ops)
        # ‖A‖_2 ≤ sqrt(‖A‖_1 ‖A‖_∞), per term, the max over the entries
        col = np.abs(ops).sum(axis=-2).max(axis=-1)
        row = np.abs(ops).sum(axis=-1).max(axis=-1)
        op2 = np.sqrt(col * row).max(axis=0)
        self.absM = np.abs(np.asarray(cp.M, dtype=np.float64))
        self.absMfix = np.abs(np.asarray(cp.Mfix, dtype=np.float64))
        self.dt = np.abs(np.diff(np.asarray(cp.tlist, dtype=np.float64)))
        # ‖μ_l(n)‖_2 ≤ Σ_j |M[n, j, l]| ‖Op_j‖_2
        mu2 = np.einsum("...ntl,t->...nl", self.absM, op2)
        if cp.per_traj_coeffs:
            mu2 = mu2.max(axis=0)
        self.dmax_per_norm = np.max(np.asarray(S_lam).T * mu2, axis=0)

    def squarings(self, A):
        c = (np.einsum("...ntl,l->...nt", self.absM, A) + self.absMfix)
        if c.ndim == 3:
            c = c.max(axis=0)
        bound = float(np.max(self.dt * (self.h0 + c @ self.op1)))
        return max(0, int(math.ceil(math.log2(max(bound, 1e-300)
                                              / self.theta))))


def _build_krotov_step(cp: CompiledProblem, S_tab, lam):
    """One Krotov iteration: ``step(flat_pulse) -> (J_T_old, eps_new
    (L, N_T), J_T_new, tau_new (K,), psi_T_new (K, d))``, host values.
    ``step.stats`` holds the last iteration's squaring count and the
    number of decisions on it, each a sweep (1, or one more for each
    regrown bound); each sweep reads J_T and the new amplitudes back once."""
    device = cp.device
    consts = _device_constants(cp, device)
    pds = _prop_data(cp)  # ExpProp in every direction: no tables
    cdt, rdt = consts["cdtype"], consts["rdtype"]
    L, N_T = cp.n_controls, cp.n_timesteps
    S_lam_np = np.asarray(S_tab, dtype=np.float64) / np.asarray(lam)[:, None]
    S_lam = torch.as_tensor(S_lam_np, dtype=rdt, device=device)
    sq = _SquaringBound(cp, S_lam_np)
    env = {"bucket": np.zeros(L)}

    def result_read(psi_T, eps_new):
        tau = (taus(psi_T, cp.trajectories) if cp.has_targets
               else torch.zeros(cp.n_traj, dtype=cdt, device=device))
        J_T_new = (cp.J_T(psi_T, cp.trajectories, tau=tau)
                   if cp.J_T_takes_tau else cp.J_T(psi_T, cp.trajectories))
        vals = torch.cat([torch.real(J_T_new).reshape(1).to(rdt),
                          eps_new.abs().amax(dim=1)]).tolist()
        return vals[0], np.asarray(vals[1:]), tau

    @torch.no_grad()
    def step(flat):
        flat = np.asarray(flat, dtype=np.float64)
        amps = np.max(np.abs(flat.reshape(L, N_T)), axis=1)
        # the forward kernels' squaring count follows the bucket, which
        # only grows
        env["bucket"] = np.maximum(env["bucket"], _bucket(amps))
        pulsevals = _as_pulse(flat, consts, device)
        eps = pulsevals.reshape(L, N_T)
        coeffs, _ = _coeff_tables(cp, consts, eps)
        storage, _, psi_T, _, Us = _evaluate_forward(
            cp, consts, coeffs, env["bucket"], pds, want_U=True)
        J_T_old, _, _, tau_old = _J_parts(cp, pulsevals, psi_T, None)
        chi_T = _chi_boundary(cp, consts, psi_T, tau_old).to(cdt)
        # the chain under the OLD pulse, not normalized: chis[n] = χ(t_{n+1})
        chis, chi0 = _chi_trajectory(cp, Us, chi_T)
        chi_start = torch.cat([chi0[None], chis[:-1]])
        # the one host read before the sweep: Σ_k max‖χ_k‖ max‖Ψ_k‖, with
        # J_T of the old pulse
        norm = torch.sum(
            torch.linalg.vector_norm(chi_start, dim=-1).amax(0)
            * torch.linalg.vector_norm(storage, dim=-1).amax(0))
        prod, J_old = torch.stack(
            [norm.to(rdt), torch.real(J_T_old).to(rdt)]).tolist()
        A = amps + sq.dmax_per_norm * prod
        s = sq.squarings(A)
        decisions = 1
        while True:
            psi_T_new, eps_new = _sweep(cp, consts, eps, chi_start, S_lam, s)
            J_new, amps_new, tau_new = result_read(psi_T_new, eps_new)
            if sq.squarings(amps_new) <= s:
                break
            # the bound did not hold: grow it and sweep again
            A = _bucket(np.maximum(amps_new, A))
            s = sq.squarings(A)
            decisions += 1
        step.stats = {"squarings": s, "squaring_decisions": decisions,
                      "amplitude_bound": A.tolist()}
        return (J_old, eps_new.cpu().numpy().astype(np.float64), J_new,
                tau_new.cpu().numpy().astype(np.complex128),
                psi_T_new.cpu().numpy().astype(np.complex128))

    step.stats = {}
    return step


def _check_scope(kwargs):
    """Refuse by name what Krotov's method does not support here."""
    for key in ("upper_bound", "lower_bound"):
        val = kwargs.get(key)
        if val is not None and np.isfinite(float(val)):
            raise NotImplementedError(
                f"optimize_krotov does not support box bounds ({key}=): "
                "Krotov's update is unconstrained; use optimize() [GRAPE]"
            )
    for options in (kwargs.get("pulse_options") or {}).values():
        if "upper_bounds" in options or "lower_bounds" in options:
            raise NotImplementedError(
                "optimize_krotov does not support box bounds "
                "(pulse_options=); use optimize() [GRAPE]"
            )


def optimize_krotov(
    trajectories, tlist, *, lambda_a=5.0, update_shape=None,
    iter_stop=50, callback=None, check_convergence=None,
    print_iters=True, store_iter_info=None, continue_from=None,
    rethrow_exceptions=False, device=None, **kwargs,
):
    """Krotov's method over the problem surface of :func:`optimize`
    (trajectories, tlist, ``J_T``, amplitude models, shared, grouped and
    per-trajectory generators); returns a :class:`KrotovResult`.

    Args:
      lambda_a: inverse update step weight λ_a (scalar or one per
        control).  Larger means smaller, safer (monotonic) updates.
      update_shape: ``S(t) ∈ [0, 1]`` scaling the update (callable or one
        per control), sampled on the interval midpoints (``t_0`` and ``T``
        for the first and last interval).  Default: constant 1.
      iter_stop / callback / check_convergence / print_iters /
        store_iter_info / continue_from / rethrow_exceptions: as in
        :func:`optimize`; the callback receives ``(result, iteration)``.
      device: ``None`` means the CUDA device and raises without one;
        ``"cpu"`` runs the plain versions in complex128.

    See the module docstring for the routing, the squaring count of the
    sweep, the two deviations from the reference and the limitations.
    """
    trajectories = list(trajectories)
    for key in _DROPPED:
        kwargs.pop(key, None)
    _check_scope(kwargs)
    from .workspace import _compile_kwargs

    cp = compile_problem(trajectories, tlist, device=device,
                         **_compile_kwargs(kwargs))
    if cp.g_b is not None or cp.xi is not None:
        raise NotImplementedError(
            "optimize_krotov does not support state-dependent running "
            "costs (g_b/xi); use optimize() [GRAPE]"
        )
    if cp.custom_terms:
        raise NotImplementedError(
            "optimize_krotov requires amplitudes linear in the controls "
            "(no CustomAmplitude)"
        )
    labels = list(store_iter_info or [])
    bad = [lab for lab in labels if lab not in _LABELS]
    if bad:
        raise ValueError(
            f"Unsupported store_iter_info label {bad[0]!r} for Krotov "
            f"(supported: {', '.join(_LABELS)})"
        )
    L, N_T = cp.n_controls, cp.n_timesteps
    lam = np.broadcast_to(np.asarray(lambda_a, dtype=np.float64), (L,)).copy()
    if np.any(lam <= 0):
        raise ValueError("lambda_a must be positive")
    tl = np.asarray(tlist, dtype=np.float64)
    tmid = 0.5 * (tl[:-1] + tl[1:])
    tmid[0], tmid[-1] = tl[0], tl[-1]
    S_tab = np.ones((L, N_T))
    if update_shape is not None:
        shapes_ = (list(update_shape)
                   if isinstance(update_shape, (list, tuple))
                   else [update_shape] * L)
        for l, s in enumerate(shapes_):
            S_tab[l] = [float(s(t)) for t in tmid]

    result_kwargs = dict(kwargs, iter_stop=iter_stop)
    if continue_from is not None:
        result = continue_from
        if not isinstance(result, KrotovResult):
            result = KrotovResult.from_result(result, trajectories, tlist,
                                              result_kwargs)
        result.iter_stop = iter_stop
        result.converged = False
        result.message = "in progress"
        result.start_local_time = datetime.datetime.now()
        pulsevals = np.concatenate([
            discretize_on_midpoints(c, result.tlist)
            for c in result.optimized_controls
        ])
        iter_offset = int(result.iter)
    else:
        result = KrotovResult(trajectories, tlist, result_kwargs)
        pulsevals = cp.guess_pulsevals.reshape(-1).copy()
        iter_offset = 0
    if iter_offset >= iter_stop:
        # deviation: the reference leaves such a run "in progress"
        result.converged = True
        result.message = "Reached maximum number of iterations"
        result.end_local_time = datetime.datetime.now()
        return result

    step = _build_krotov_step(cp, S_tab, lam)

    def record(i, J, dJ, secs):
        row = []
        for lab in labels:
            if lab == "iter.":
                row.append(i)
            elif lab == "J_T":
                row.append(J)
            elif lab in ("ΔJ", "ΔJ_T"):
                row.append(dJ)
            else:
                row.append(secs)
        if row:
            result.records.append(tuple(row))

    if print_iters:
        print(" iter.        J_T         ΔJ    secs")
    flat = np.asarray(pulsevals, dtype=np.float64)
    t_prev = time.perf_counter()
    try:
        for i in range(iter_offset + 1, iter_stop + 1):
            J_old, eps_new, J_new, tau_new, psi_new = step(flat)
            now = time.perf_counter()
            if i == iter_offset + 1:
                # the iteration-0 row: the guess functional
                result.J_T = J_old
                if print_iters:
                    print(f"{i - 1:6d}   {J_old:.2e}        n/a     "
                          f"{now - t_prev:.1f}")
                record(i - 1, J_old, None, now - t_prev)
                if callback is not None:
                    callback(result, i - 1)
            result.iter = i
            result.J_T_prev = J_old
            result.J_T = J_new
            result.f_calls += 1
            result.fg_calls += 1
            result.tau_vals = tau_new
            result.states = list(psi_new)
            result.optimized_controls = [
                discretize(eps_new[l], np.asarray(result.tlist))
                for l in range(L)
            ]
            secs = time.perf_counter() - t_prev
            t_prev = time.perf_counter()
            result.secs = secs
            dJ = J_new - J_old
            if print_iters:
                print(f"{i:6d}   {J_new:.2e}   {dJ:+.2e}     {secs:.1f}")
            record(i, J_new, dJ, secs)
            if dJ > 1e-12 * max(1.0, abs(J_old)):  # above rounding
                warnings.warn(
                    f"Krotov iteration {i} increased J_T by {dJ:.2e}: "
                    f"lambda_a={lam.max():g} is too small for a "
                    "monotonic update",
                    stacklevel=2,
                )
            flat = eps_new.reshape(-1)
            if callback is not None:
                callback(result, i)
            if check_convergence is not None:
                apply_convergence_check(result, check_convergence)
                if result.converged:
                    break
            if i >= iter_stop:
                result.converged = True
                result.message = "Reached maximum number of iterations"
    except Exception as exc:  # noqa: BLE001 — the reference's capture
        if rethrow_exceptions:
            raise
        result.message = f"Exception: {exc}"
    result.end_local_time = datetime.datetime.now()
    return result
