"""The GRAPE function-and-gradient evaluation in PyTorch.

Counterpart of ``grape_tpu/fg.py`` for the gate-optimization main path:
K trajectories under ONE shared generator, linear amplitudes, dense
ExpProp propagation, full storage, ``gradient_method="gradgen"``:

- forward: per step ``U_n = exp(-i H_n dt_n)`` and ``Ψ ← Ψ U_nᵀ`` for the
  whole ``(K, d)`` state block, storing every state and every ``U_n``;
- co-states: ``χ_k(T) = -∂J_T/∂⟨Ψ_k(T)|`` by analytic formula or
  ``torch.autograd`` semi-AD, normalised by ``ρ_k = ‖χ_k(T)‖``;
- backward, phase A: the co-state chain ``χ ← χ conj(U_n)`` over the
  stored propagators;
- backward, phase B: per (step, trajectory) ONE Fréchet derivative in the
  rank-1 direction ``R = ψχ†`` serves all control directions through
  ``tr(L(A, B)·M) = tr(B·L(A, M))``, reduced to the traces
  ``tr(Op_t·L(A_n, R_nk))`` and contracted with ``∂a_t/∂ε_l``;
- assembly: ``(∇J_T)_{nl} = -2 Re Σ_k ∇τ_{knl}`` plus ``λ_a ∇J_a``.

In complex64 the three heavy phases run in the hand-written CUDA kernels of
``ops.hopper_prop`` and ``ops.hopper_frechet`` (their plain PyTorch
versions for CPU tensors); in complex128 they run in plain PyTorch with
Padé-13 and ``torch.linalg.solve``, the arithmetic the reference uses in
double precision.  Everything else (coefficient tables, ``J_T``, χ(T), the
contraction with ``dM``) is plain PyTorch in both.

Not ported yet, and raising ``NotImplementedError`` when asked for:
``gradient_method="taylor"``, ``prop_method="cheby"|"newton"``,
``storage_mode="recompute"``, state running costs ``g_b``/``xi``,
``CustomAmplitude``, per-trajectory generators or coefficient tables,
``mesh=`` sharding and the forward-propagation observables callback.
"""

from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from .config import (
    complex_dtype, numpy_dtype, real_dtype, resolve_device, torch_dtype,
)
from .controls import discretize_on_midpoints, get_controls
from .functionals import accepts_tau, make_chi, make_grad_J_a, taus
from .ops.expm import _THETA13_F64, _THETA_TAYLOR_F32, expm
from .ops.frechet import expm_frechet
from .ops.hopper_frechet import frechet_trace_shared
from .ops.hopper_prop import chi_scan_shared, forward_scan_shared

__all__ = ["CompiledProblem", "compile_problem", "build_fg", "build_f"]


@dataclass
class CompiledProblem:
    """Static arrays + closures defining one GRAPE problem.

    The arrays are host numpy (bit-identical to what the reference's
    ``compile_problem`` produces for the same input); ``build_fg`` /
    ``build_f`` move them to ``device`` once.
    """

    psi0: Any          # (K, d) complex
    H0: Any            # (1, d, d) complex: ONE shared drift
    ops: Any           # (1, T, d, d) complex control-term operators
    M: Any             # (N_T, T, L) real: coeffs_n = M[n] @ eps_n
    Mfix: Any          # (N_T, T) real: fixed (locked-amplitude) coefficients
    tlist: Any         # (N_T+1,) real
    trajectories: list
    controls: tuple
    guess_pulsevals: Any   # (L, N_T) float64 numpy
    n_controls: int
    n_timesteps: int
    dim: int
    n_traj: int
    J_T: Callable = None
    chi: Callable = None
    J_a: Callable = None
    grad_J_a: Callable = None
    lambda_a: float = 1.0
    gradient_method: str = "gradgen"
    chi_min_norm: float = 1e-100
    J_T_takes_tau: bool = False
    chi_takes_tau: bool = False
    has_targets: bool = False
    prop_method: str = "expprop"
    storage_mode: str = "full"
    ctl_idx: tuple = ()  # static control index per term (None = locked)
    # all trajectories evolve under the SAME generator (gate optimization:
    # K basis states, one H) — U_n is computed once per step, not per k
    shared_generator: bool = True
    # host-side operator norms cached at compile time:
    # {"h0": ||H0||_1, "ops": (T,) per-term ||Op_j||_1}
    norm_cache: Any = None
    # memo for the host-side coefficient envelope (keyed by amp_max)
    env_cache: Any = field(default_factory=dict)
    device: Any = None

    @property
    def dt(self):
        return np.diff(self.tlist)


# keyword -> value that means "not asked for"; anything else is an option
# the port does not support yet
_UNPORTED_DEFAULTS = {
    "g_b": None,
    "xi": None,
    "taylor_grad_max_order": 100,
    "taylor_grad_tolerance": 1e-16,
    "taylor_grad_check_convergence": True,
    "cheby_tol": 1e-14,
    "storage_segments": None,
    "newton_m": 30,
    "newton_substeps": 1,
    "reuse_propagators": "auto",
    "vectorize_backward": True,
    "fw_prop_callback": None,
    "fw_prop_observables": None,
    "mesh": None,
    "_controls": None,
}


def _normalize_prop_method(prop_method):
    if prop_method is None:
        return "expprop"
    name = getattr(prop_method, "__name__", str(prop_method)).lower()
    if name in ("expprop", "exp", "expm"):
        return "expprop"
    if name in ("cheby", "chebyshev", "chebychev"):
        return "cheby"
    if name in ("newton", "krylov", "arnoldi"):
        return "newton"
    raise ValueError(f"Unknown prop_method: {prop_method!r}")


def _check_ported(gradient_method, storage_mode, prop_methods, options):
    """Raise ``NotImplementedError`` naming the first unported option."""
    if gradient_method not in ("gradgen", "auto"):
        raise NotImplementedError(
            f"gradient_method={gradient_method!r} is not ported to "
            "grape_tpu_torch yet (only 'gradgen')"
        )
    if storage_mode != "full":
        raise NotImplementedError(
            f"storage_mode={storage_mode!r} is not ported to "
            "grape_tpu_torch yet (only 'full')"
        )
    for key, val in prop_methods.items():
        if _normalize_prop_method(val) != "expprop":
            raise NotImplementedError(
                f"{key}={val!r} is not ported to grape_tpu_torch yet "
                "(only ExpProp)"
            )
    for key, val in options.items():
        if key not in _UNPORTED_DEFAULTS:
            raise TypeError(
                f"compile_problem() got an unexpected keyword {key!r}"
            )
        default = _UNPORTED_DEFAULTS[key]
        if val is not default and val != default:
            raise NotImplementedError(
                f"{key}= is not ported to grape_tpu_torch yet"
            )


def compile_problem(
    trajectories,
    tlist,
    *,
    J_T,
    chi=None,
    J_a=None,
    grad_J_a=None,
    lambda_a=1.0,
    lambda_b=1.0,
    gradient_method="gradgen",
    chi_min_norm=1e-100,
    dtype=None,
    prop_method=None,
    fw_prop_method=None,
    bw_prop_method=None,
    grad_prop_method=None,
    storage_mode="full",
    device=None,
    **options,
):
    """Compile trajectories + tlist into a :class:`CompiledProblem`.

    Extract the distinct controls, discretize them on the interval
    midpoints into the guess pulse vector, stack the trajectory data along
    the batch axis, and build the static per-interval coefficient tensor
    ``M`` — the same arrays the reference's ``compile_problem`` builds.

    ``device=None`` means the CUDA device (and raises without one);
    ``dtype=None`` means complex64 there and complex128 on the CPU.  A
    keyword for a feature that is not ported yet raises
    ``NotImplementedError``; an unknown keyword raises ``TypeError``.
    """
    device = resolve_device(device)
    _check_ported(
        gradient_method, storage_mode,
        {"prop_method": prop_method, "fw_prop_method": fw_prop_method,
         "bw_prop_method": bw_prop_method,
         "grad_prop_method": grad_prop_method},
        options,
    )
    trajectories = list(trajectories)
    tlist = np.asarray(tlist, dtype=np.float64)
    N_T = len(tlist) - 1
    K = len(trajectories)
    if K == 0:
        raise ValueError("no trajectories")
    for t in trajectories:
        for key in ("prop_method", "fw_prop_method", "bw_prop_method",
                    "grad_prop_method"):
            if key in getattr(t, "kwargs", {}):
                raise NotImplementedError(
                    f"per-trajectory {key} settings are not ported to "
                    "grape_tpu_torch yet"
                )

    generators = [t.generator for t in trajectories]
    controls = get_controls(generators)
    L = len(controls)
    if L == 0:
        raise ValueError(
            # exact reference wording (test/test_empty_optimization.jl:36)
            "no controls in trajectories: cannot optimize"
        )
    guess = np.stack(
        [discretize_on_midpoints(c, tlist) for c in controls]
    )  # (L, N_T)

    if dtype is None:
        dtype = np.complex64 if device.type == "cuda" else np.complex128
    cdtype = complex_dtype(numpy_dtype(dtype))

    g0 = generators[0]
    n_terms = len(g0.terms)
    dim = g0.dim
    ctl_idx = g0.term_control_indices(controls)
    M, Mfix = g0.coefficient_tables(tlist, controls)

    # gate-optimization detection: one generator, K basis states.  Shared
    # operator arrays are stored with a LENGTH-1 leading axis.
    same_gen = all(g is g0 for g in generators)
    if not same_gen:
        same_gen = all(
            g.dim == dim and len(g.terms) == n_terms
            and g.term_control_indices(controls) == ctl_idx
            and np.array_equal(g.drift, g0.drift)
            and all(np.array_equal(op, op0)
                    for (op, _), (op0, _) in zip(g.terms, g0.terms))
            and all(
                np.array_equal(t, t0) for t, t0 in zip(
                    g.coefficient_tables(tlist, controls), (M, Mfix))
            )
            for g in generators[1:]
        )
    if not same_gen:
        raise NotImplementedError(
            "per-trajectory generators (ensembles of different "
            "Hamiltonians) are not ported to grape_tpu_torch yet: all "
            "trajectories must share one generator"
        )
    H0 = np.stack([g0.drift]).astype(cdtype)
    if n_terms > 0:
        ops = np.stack(
            [np.stack([op for (op, _) in g0.terms])]
        ).astype(cdtype)  # (1, T, d, d)
    else:
        ops = np.zeros((1, 0, dim, dim), dtype=cdtype)

    psi0 = np.stack([t.initial_state for t in trajectories]).astype(cdtype)
    has_targets = all(t.target_state is not None for t in trajectories)

    if chi is None:
        chi = make_chi(J_T, trajectories)
    if J_a is not None and grad_J_a is None:
        grad_J_a = make_grad_J_a(J_a, tlist)

    rdtype = real_dtype(cdtype)
    return CompiledProblem(
        psi0=np.asarray(psi0),
        H0=np.asarray(H0),
        ops=np.asarray(ops),
        M=np.asarray(M, dtype=rdtype),
        Mfix=np.asarray(Mfix, dtype=rdtype),
        tlist=np.asarray(tlist, dtype=rdtype),
        trajectories=trajectories,
        controls=controls,
        guess_pulsevals=guess,
        n_controls=L,
        n_timesteps=N_T,
        dim=dim,
        n_traj=K,
        J_T=J_T,
        chi=chi,
        J_a=J_a,
        grad_J_a=grad_J_a,
        lambda_a=float(lambda_a),
        gradient_method="gradgen",
        chi_min_norm=float(chi_min_norm),
        J_T_takes_tau=accepts_tau(J_T) and has_targets,
        chi_takes_tau=accepts_tau(chi) and has_targets,
        has_targets=has_targets,
        storage_mode=storage_mode,
        ctl_idx=tuple(ctl_idx),
        shared_generator=True,
        norm_cache=_make_norm_cache(H0, ops),
        device=device,
    )


def _make_norm_cache(H0, ops):
    """Host-side operator 1-norms captured at compile time."""
    K = H0.shape[0]
    return {
        "h0": max(
            float(np.abs(H0[k]).sum(axis=0).max()) for k in range(K)
        ),
        "ops": np.asarray([
            max(
                float(np.abs(ops[k, j]).sum(axis=0).max())
                for k in range(K)
            )
            for j in range(ops.shape[1])
        ]),
    }


# --------------------------------------------------------------------------
# Host-side amplitude envelope -> static squaring count
# --------------------------------------------------------------------------

def _default_amp_max(cp: CompiledProblem):
    return np.maximum(np.max(np.abs(cp.guess_pulsevals), axis=1), 0.1)


def _coeff_env(cp: CompiledProblem, amp_max):
    """Host-side envelope of the per-interval coefficients and their
    control derivatives over the pulse box ``|ε_l| ≤ amp_max_l``:
    ``(cmax (T,), dmax (T, L))`` numpy (linear amplitudes)."""
    amp_max = np.asarray(amp_max, dtype=np.float64)
    key = tuple(amp_max.ravel().tolist())
    if key in cp.env_cache:
        return cp.env_cache[key]
    absM = np.abs(np.asarray(cp.M))
    absMfix = np.abs(np.asarray(cp.Mfix))
    cmax = (np.einsum("ntl,l->nt", absM, amp_max) + absMfix).max(axis=0)
    dmax = absM.max(axis=0)
    cp.env_cache[key] = (cmax, dmax)
    return cmax, dmax


def _op_norms(cp: CompiledProblem):
    """``(‖H0‖_1, per-term ‖Op_j‖_1)`` from the compile-time cache."""
    if cp.norm_cache is None:
        cp.norm_cache = _make_norm_cache(cp.H0, cp.ops)
    return cp.norm_cache["h0"], np.asarray(cp.norm_cache["ops"])


def _h_norm_bound(cp: CompiledProblem, amp_max=None):
    """Host-side envelope bound on ``‖H_n‖_1``:
    ``||H0||_1 + sum_j cmax_j ||Op_j||_1``."""
    if amp_max is None:
        amp_max = 2.0 * _default_amp_max(cp)
    cmax, _ = _coeff_env(cp, amp_max)
    h0n, opn = _op_norms(cp)
    coupling = float(np.dot(cmax, opn)) if len(opn) else 0.0
    return h0n + coupling


def _step_norm_bound(cp: CompiledProblem, amp_max=None):
    """Host-side envelope bound on ``|dt|·‖H_n‖_1`` (the reference's
    ``_pallas_norm_bound``)."""
    dt_max = float(np.max(np.diff(np.asarray(cp.tlist))))
    return dt_max * _h_norm_bound(cp, amp_max)


def _static_squarings(cp: CompiledProblem, amp_max=None):
    """Squaring count ``s`` from the host-side amplitude envelope (the
    reference's ``_pallas_squarings``): the same ``s`` as the reference for
    the same envelope.  The kernels take it as a runtime integer."""
    bound = _step_norm_bound(cp, amp_max)
    theta = _THETA_TAYLOR_F32
    return max(0, int(np.ceil(np.log2(max(bound, 1e-30) / theta))))


def _kernels_enabled(cp: CompiledProblem):
    """The kernel wrappers (and, for CPU tensors, their plain versions)
    serve complex64, as the TPU kernels are gated on it; complex128 takes
    the plain Padé-13 path."""
    return np.dtype(cp.psi0.dtype) == np.complex64


# --------------------------------------------------------------------------
# The evaluation phases
# --------------------------------------------------------------------------

def _device_constants(cp: CompiledProblem, device):
    """The problem arrays as tensors on ``device`` (made once per build)."""
    cdt = torch_dtype(cp.psi0.dtype)
    rdt = real_dtype(cdt)

    def c(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=cdt,
                               device=device)

    def r(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=rdt,
                               device=device)

    tl = r(cp.tlist)
    return {
        "psi0": c(cp.psi0), "H0": c(cp.H0[0]), "ops": c(cp.ops[0]),
        "M": r(cp.M), "Mfix": r(cp.Mfix), "tlist": tl,
        "dt": torch.diff(tl).contiguous(), "cdtype": cdt, "rdtype": rdt,
    }


def _coeff_tables(consts, eps):
    """Per-interval term coefficients and their control derivatives for
    the CURRENT pulse values ``eps (L, N_T)``: ``(coeffs (N_T, T),
    dM (N_T, T, L))``.  Linear amplitudes: ``M @ ε + Mfix`` and ``M``."""
    coeffs = torch.einsum("ntl,ln->nt", consts["M"], eps) + consts["Mfix"]
    return coeffs, consts["M"]


def _expm_steps(A):
    """``expm`` of each matrix of the batch ``A (N, d, d)`` with its OWN
    norm-derived squaring count (what a per-step scan computes), batched by
    grouping the steps of equal count."""
    single = A.dtype == torch.complex64
    theta = _THETA_TAYLOR_F32 if single else _THETA13_F64
    norms = torch.amax(torch.sum(torch.abs(A), dim=-2), dim=-1)
    s = torch.clamp(
        torch.ceil(torch.log2(torch.clamp(norms, min=1e-300) / theta)),
        min=0, max=32,
    ).to(torch.int64)
    out = torch.empty_like(A)
    for val in torch.unique(s).tolist():
        idx = torch.nonzero(s == val).squeeze(-1)
        out[idx] = expm(A[idx], squarings=int(val))
    return out


def _forward(cp: CompiledProblem, consts, coeffs, amp_max):
    """Forward propagation with the propagator stream:
    ``(storage (N_T+1, K, d), Us (N_T, d, d))``."""
    if _kernels_enabled(cp):
        return forward_scan_shared(
            consts["H0"], consts["ops"],
            coeffs.to(torch.float32).contiguous(),
            consts["dt"].to(torch.float32),
            consts["psi0"], _static_squarings(cp, amp_max),
        )
    cdt = consts["cdtype"]
    H = consts["H0"][None] + torch.einsum(
        "nt,tij->nij", coeffs.to(cdt), consts["ops"]
    )
    Us = _expm_steps((-1j * consts["dt"].to(cdt))[:, None, None] * H)
    psi = consts["psi0"]
    states = [psi]
    for n in range(cp.n_timesteps):
        psi = psi @ Us[n].T
        states.append(psi)
    return torch.stack(states), Us


def _J_parts(cp: CompiledProblem, pulsevals, storage):
    """``[J_T, λ_a J_a, λ_b J_b]`` and tau values from the forward storage
    (``J_b`` is zero: state running costs are not ported)."""
    psi_T = storage[-1]
    tau = taus(psi_T, cp.trajectories) if cp.has_targets else None
    if cp.J_T_takes_tau:
        J_T_val = cp.J_T(psi_T, cp.trajectories, tau=tau)
    else:
        J_T_val = cp.J_T(psi_T, cp.trajectories)
    zero = torch.zeros((), dtype=J_T_val.dtype, device=J_T_val.device)
    J_a_val = zero
    if cp.J_a is not None:
        J_a_val = cp.lambda_a * cp.J_a(pulsevals, cp.tlist)
    return J_T_val, J_a_val, zero, tau


def _chi_boundary(cp: CompiledProblem, psi_T, tau):
    """``χ(T)``."""
    if cp.chi_takes_tau:
        return cp.chi(psi_T, cp.trajectories, tau=tau)
    return cp.chi(psi_T, cp.trajectories)


def _chi_trajectory(cp: CompiledProblem, Us, chi_hat):
    """Phase A of the vectorized backward pass: the normalized co-state
    trajectory via the stored shared propagators, ``χ ← χ conj(U_n)`` in
    reverse time.  Returns ``chis (N_T, K, d)`` with
    ``chis[n] = χ(t_{n+1})`` (what step ``n``'s gradient consumes)."""
    if _kernels_enabled(cp):
        return chi_scan_shared(Us, chi_hat.contiguous())
    chi = chi_hat
    out = [None] * cp.n_timesteps
    for n in range(cp.n_timesteps - 1, -1, -1):
        out[n] = chi
        if n > 0:
            chi = chi @ Us[n].conj()
    return torch.stack(out)


def _gradgen_chunk(cp: CompiledProblem, n_steps=None, n_intermediates=8,
                   budget_bytes=1 * 1024**3):
    """Time-chunk length for the plain vectorized gradgen pass: a divisor
    of ``n_steps`` sized so the chunk's (C, K, d, d) intermediates stay
    within the memory budget."""
    if n_steps is None:
        n_steps = cp.n_timesteps
    per_step = (
        cp.n_traj * cp.dim * cp.dim * np.dtype(cp.psi0.dtype).itemsize
        * n_intermediates
    )
    target = max(1, min(n_steps, int(budget_bytes // max(per_step, 1))))
    divisors = [c for c in range(1, n_steps + 1) if n_steps % c == 0]
    return max(c for c in divisors if c <= target)


def _backward_vectorized_gradgen(cp: CompiledProblem, consts, coeffs, dM,
                                 psis, chis, rho, amp_max=None):
    """Time-vectorized gradgen backward pass, phase B.

    The per-step gradient only needs the scalar
    ``∇τ_{nl} = ρ·χ(t_{n+1})† L(A_n, B_nl) ψ(t_n)`` with
    ``A_n = -i dt H_n`` and ``B_nl = -i dt μ_nl``.  By
    ``tr(L(A, B)·M) = tr(B·L(A, M))`` ONE Fréchet evaluation per (n, k) in
    the rank-1 direction ``R = ψχ†`` serves ALL ``L`` control directions,
    each reduced to a trace-dot with ``μ_nl``.

    ``psis (N_T, K, d)`` holds the states at the step starts, ``chis`` the
    matching co-states.  Returns ``tau_grads (N_T, K, L)`` (ρ-scaled).
    """
    cdt = consts["cdtype"]
    dt = consts["dt"]
    dMc = dM.to(cdt)
    n_sq = _static_squarings(cp, amp_max)
    a_all = (-1j * dt).to(cdt)

    if _kernels_enabled(cp):
        trj = frechet_trace_shared(
            consts["H0"], consts["ops"],
            coeffs.to(torch.float32).contiguous(), dt.to(torch.float32),
            psis.contiguous(), chis.contiguous(), n_sq,
        )  # (N_T, K, T)
        grads = a_all[:, None, None] * torch.einsum(
            "ntl,nkt->nkl", dMc, trj
        )
        return rho[None, :, None].to(cdt) * grads

    N_T = psis.shape[0]
    C = _gradgen_chunk(cp, n_steps=N_T)
    coeffs_c = coeffs.to(cdt)
    out = []
    for c0 in range(0, N_T, C):
        cs = slice(c0, c0 + C)
        a = a_all[cs]
        # rank-1 direction R[b, a] = ψ_b(t_n) conj(χ_a(t_{n+1}))
        R = torch.einsum("ckb,cka->ckba", psis[cs], chis[cs].conj())
        Hc = consts["H0"][None] + torch.einsum(
            "ct,tij->cij", coeffs_c[cs], consts["ops"]
        )
        Af = a[:, None, None] * Hc
        _E, G = expm_frechet(Af, R, squarings=n_sq)  # (C, K, d, d)
        trj = torch.einsum("tab,ckba->ckt", consts["ops"], G)
        out.append(
            a[:, None, None] * torch.einsum("ctl,ckt->ckl", dMc[cs], trj)
        )
    grads = torch.cat(out)
    return rho[None, :, None].to(cdt) * grads


def _as_pulse(pulsevals, consts, device):
    return torch.as_tensor(
        np.asarray(pulsevals) if not torch.is_tensor(pulsevals)
        else pulsevals,
        dtype=consts["rdtype"], device=device,
    )


def _zero_tau(cp, consts, device):
    return torch.zeros(cp.n_traj, dtype=consts["cdtype"], device=device)


def build_f(cp: CompiledProblem, amp_max=None, device=None):
    """Functional-only evaluation ``f(pulsevals) -> (J, aux)`` (line-search
    F-only probes).  ``device=None`` means the device the problem was
    compiled for."""
    device = cp.device if device is None else resolve_device(device)
    consts = _device_constants(cp, device)

    @torch.no_grad()
    def f(pulsevals):
        pulsevals = _as_pulse(pulsevals, consts, device)
        eps = pulsevals.reshape(cp.n_controls, cp.n_timesteps)
        coeffs, _ = _coeff_tables(consts, eps)
        storage, _ = _forward(cp, consts, coeffs, amp_max)
        J_T_val, J_a_val, J_b_val, tau = _J_parts(cp, pulsevals, storage)
        J = J_T_val + J_a_val + J_b_val
        aux = {
            "J_parts": torch.stack([J_T_val, J_a_val, J_b_val]),
            "tau": tau if tau is not None else _zero_tau(cp, consts, device),
            "psi_T": storage[-1],
        }
        return J, aux

    return f


def build_fg(cp: CompiledProblem, amp_max=None, device=None):
    """Function-and-gradient evaluation.

    Returns ``fg(pulsevals_flat) -> (J, grad_flat, aux)`` (torch tensors on
    the device) with the flat l-major pulse layout
    ``[ε_11.. ε_{N_T}1, ε_12..]``.  ``aux`` has the reference's keys;
    ``tau`` and ``psi_T`` are complex tensors.  ``device=None`` means the
    device the problem was compiled for.
    """
    device = cp.device if device is None else resolve_device(device)
    consts = _device_constants(cp, device)
    cdt = consts["cdtype"]

    @torch.no_grad()
    def fg(pulsevals):
        pulsevals = _as_pulse(pulsevals, consts, device)
        eps = pulsevals.reshape(cp.n_controls, cp.n_timesteps)
        coeffs, dM = _coeff_tables(consts, eps)
        storage, Us = _forward(cp, consts, coeffs, amp_max)
        J_T_val, J_a_val, J_b_val, tau = _J_parts(cp, pulsevals, storage)
        J = J_T_val + J_a_val + J_b_val
        psi_T = storage[-1]

        chi_T = _chi_boundary(cp, psi_T, tau).to(cdt)
        rho = torch.sqrt(torch.sum(torch.abs(chi_T) ** 2, dim=-1))  # (K,)
        chi_ok = torch.all(rho > cp.chi_min_norm)
        safe_rho = torch.where(rho > 0, rho, torch.ones_like(rho))
        chi_hat = chi_T / safe_rho[:, None].to(cdt)

        chis = _chi_trajectory(cp, Us, chi_hat)
        tau_grads = _backward_vectorized_gradgen(
            cp, consts, coeffs, dM, storage[:-1], chis, rho, amp_max
        )

        grad_Tb = -2.0 * torch.real(torch.sum(tau_grads, dim=1))  # (N_T, L)
        grad_Tb_flat = grad_Tb.T.reshape(-1)  # l-major flat layout
        grad = grad_Tb_flat
        if cp.grad_J_a is not None:
            grad_J_a_flat = torch.reshape(
                torch.as_tensor(cp.grad_J_a(pulsevals, cp.tlist)),
                grad.shape,
            ).to(grad.dtype)
            grad = grad + cp.lambda_a * grad_J_a_flat
        else:
            grad_J_a_flat = torch.zeros_like(grad)
        aux = {
            "grad_J_Tb": grad_Tb_flat,
            "grad_J_a": grad_J_a_flat,
            "J_parts": torch.stack([J_T_val, J_a_val, J_b_val]),
            "tau": tau if tau is not None else _zero_tau(cp, consts, device),
            "psi_T": psi_T,
            "chi_ok": chi_ok,
            "taylor_ok": torch.ones((), dtype=torch.bool, device=device),
            "chi_norms": rho,
        }
        return J, grad, aux

    return fg
