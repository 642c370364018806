"""The GRAPE function-and-gradient evaluation in PyTorch.

Counterpart of ``grape_tpu/fg.py``: linear and nonlinear
(``CustomAmplitude``) amplitudes, ExpProp, Chebyshev or Krylov propagation,
full or checkpoint/recompute storage, ``gradient_method="gradgen"`` or
``"taylor"`` (``"auto"`` picks one), the final-time functional plus the
pulse running cost ``J_a`` and the state running cost ``g_b`` (with its
co-state source ``ξ``), with the K trajectories in G groups of gs
contiguous ones that share a generator.  G = 1 is gate optimization (K
basis states, one Hamiltonian); gs > 1 a gate ensemble (each Hamiltonian
sample propagates its basis states); gs = 1 a robust ensemble of K distinct
generators, which may also differ in their coefficient tables
(``per_traj_coeffs``):

- forward: per step and group ``U_ng = exp(-i H_ng dt_n)`` and
  ``Ψ ← Ψ U_ngᵀ`` for the group's ``(gs, d)`` state block, storing every
  state and, while the stream fits the budget of ``_gg_u_bytes_ok``, every
  ``U_ng``; with ``storage_mode="recompute"`` only the state at the start
  of each of ``S ≈ √N_T`` segments is kept, and the backward pass
  propagates each segment again from its checkpoint (memory O(√N_T)
  states);
- co-states: ``χ_k(T) = -∂J_T/∂⟨Ψ_k(T)|`` (plus ``λ_b·dt/2·ξ(T)``) by
  analytic formula or ``torch.autograd`` semi-AD, normalised by
  ``ρ_k = ‖χ_k(T)‖``;
- backward, phase A: the co-state chain ``χ ← χ conj(U_ng)`` over the
  stored propagators, or over propagators formed again window by window
  where the stream was not kept, with the source
  ``λ_b·w_n·ξ(ψ(t_n))/ρ_k`` added at each interior grid point;
- backward, phase B: per (step, trajectory) ONE Fréchet derivative in the
  rank-1 direction ``R = ψχ†`` serves all control directions through
  ``tr(L(A, B)·M) = tr(B·L(A, M))``, reduced to the traces
  ``tr(Op_gt·L(A_ng, R_nk))`` and contracted with ``∂a_t/∂ε_l``;
- backward, phase B with ``gradient_method="taylor"``: the Taylor
  recursion ``χ' = Σ_m (i dt)^m/m! Φ_m``, ``Φ_m = μ†(H†)^{m-1}χ + H†Φ_{m-1}``
  for all steps of a window at once on ``(C, K, L, d)`` tensors, with a
  static order count from the amplitude envelope and an honest check of
  the last term (``aux["taylor_ok"]``);
- the per-step backward pass, one step at a time in reverse (the
  fallback): ``vectorize_backward=False``, a Taylor series that no static
  order within ``taylor_grad_max_order`` covers, or a gradgen problem
  whose propagator stream is past its budget with no kernel to form it
  again (complex128);
- assembly: ``(∇J_T)_{nl} = -2 Re Σ_k ∇τ_{knl}`` plus ``λ_a ∇J_a``.

Phases A and B take a time window (the whole grid under full storage, one
segment under recompute), so one code path serves both storage modes.

In complex64 the forward scan, the co-state chain (without ``ξ``) and the
Fréchet traces run in the hand-written CUDA kernels of ``ops.hopper_prop``
and ``ops.hopper_frechet`` (their plain PyTorch versions for CPU tensors),
under recompute once per segment; in complex128 they run in plain PyTorch
with Padé-13 and ``torch.linalg.solve``, the arithmetic the reference uses
in double precision.  Everything else (coefficient tables, ``J_T``, the
running costs, χ(T), the ``ξ`` chain, the contraction with ``dM``, the
Taylor recursion) is plain PyTorch in both.

Propagation in each direction (``fw_prop_method``, ``bw_prop_method``,
``grad_prop_method``, each defaulting to ``prop_method``) is ExpProp (the
above), the Chebyshev series (``"cheby"``, ``ops.cheby``) or the Krylov
series (``"newton"``, ``ops.newton``).  Where forward or backward
propagation is not ExpProp no propagator is stored: the co-state chain runs
the adjoint series step by step, and ``gradient_method="gradgen"`` takes the
per-step pass with the series of the extended state ``(χ'_1..χ'_L, χ)``
under the gradient generator.  For a shared generator in complex64 at
``256 ≤ dim ≤ CHEBY_MAX_DIM`` the Chebyshev forward scan and co-state chain
run in the hand-written kernels of ``ops.hopper_cheby``; every other
Chebyshev or Krylov step is plain PyTorch, as in the reference.

``fw_prop_callback`` receives per-step observables (or the states) of
every evaluation under full storage.  A propagator setting carried by the
trajectories themselves (``Trajectory(..., prop_method=...)``) is adopted
where it is uniform; a heterogeneous one is compiled by
``fg_hetero.compile_heterogeneous`` (one problem per partition, over the
global control list), which ``build_fg`` and ``build_f`` dispatch to.  A
problem that ``parallel.shard_problem`` cut into one rank's block of
trajectories (``cp.mesh`` set) is evaluated by ``parallel.build_fg_sharded``
and ``build_f_sharded``, which ``build_fg`` and ``build_f`` dispatch to as
well: the rank's block through the phases below, the cross-trajectory
quantities through ``torch.distributed`` collectives.
"""

import itertools
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from .amplitudes import CustomAmplitude
from .config import (
    complex_dtype, default_complex, numpy_dtype, real_dtype, resolve_device,
    torch_dtype,
)
from .controls import discretize_on_midpoints, get_controls, midpoints
from .functionals import (
    accepts_tau, grid_weights, make_chi, make_grad_J_a, make_xi,
    running_cost_values, taus,
)
from .generators import align_generators
from .ops import plain_forced
from .ops.cheby import cheby_apply, cheby_coeffs, spectral_envelope
from .ops.expm import _THETA13_F64, _THETA_TAYLOR_F32, expm
from .ops.frechet import expm_frechet, gradgen_step, taylor_grad_step
from .ops.hopper_cheby import CHEBY_MAX_DIM, cheby_scan
from .ops.hopper_frechet import frechet_trace_pertraj, frechet_trace_shared
from .ops.hopper_taylor import taylor_pass, taylor_plan
from .ops.hopper_prop import (
    SMALLD_MAX_DIM, SMALLD_MIN_TRAJ, chi_scan_grouped, chi_scan_recompute,
    chi_scan_shared, chi_window_plain, forward_scan_grouped, forward_scan_pertraj, forward_scan_shared,
    forward_scan_smalld, taylor_order_for_bound,
)
from .ops.newton import arnoldi_expmv
from .tracing import span

__all__ = [
    "CompiledProblem", "compile_problem", "build_fg", "build_fg_multicall",
    "build_f", "uses_static_envelope",
]

# from this dimension on (and for few enough columns) the vectorized Taylor
# pass applies the T+1 static operators instead of materializing the
# (N_T, d, d) generators
_STATIC_H_MIN_DIM = 128

# the Chebyshev-scan kernel: dimension from which it is taken (the
# reference's gate, a TPU threshold kept so that both packages route alike)
_CHEBY_MIN_DIM = 256

# up to this dimension the vectorized Taylor pass forms its (d, d)·(d,)
# products as a broadcast multiply and a sum over d: a batched matrix
# product of a few hundred thousand 3 x 3 matrices goes through one library
# call per product that costs far more than the bytes it moves
_ELEMENTWISE_MAX_DIM = 4

# the order count of the time-vectorized Taylor passes: the last pass's,
# the sum over every pass since the process started, and the part of that
# sum run by the Taylor-order kernel (one launch an order)
taylor_orders = {"last": 0, "total": 0, "kernel": 0}


@dataclass
class CompiledProblem:
    """Static arrays + closures defining one GRAPE problem.

    The arrays are host numpy (bit-identical to what the reference's
    ``compile_problem`` produces for the same input); ``build_fg`` /
    ``build_f`` move them to ``device`` once.
    """

    psi0: Any          # (K, d) complex
    H0: Any            # (1 | G | K, d, d) complex drifts
    ops: Any           # (1 | G | K, T, d, d) complex control-term operators
    M: Any             # (N_T, T, L) real: coeffs_n = M[n] @ eps_n
                       # ((K, N_T, T, L) when per_traj_coeffs)
    Mfix: Any          # (N_T, T) real: fixed (locked-amplitude) coefficients
                       # ((K, N_T, T) when per_traj_coeffs)
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
    # state running cost g_b(Psi, trajectories, tlist, n) -> (K,) and its
    # co-state source xi(Psi, trajectories, tlist, n) -> (K, d)
    g_b: Callable = None
    xi: Callable = None
    lambda_b: float = 1.0
    gradient_method: str = "gradgen"
    taylor_grad_max_order: int = 100
    taylor_grad_tolerance: float = 1e-16
    taylor_grad_check_convergence: bool = True
    chi_min_norm: float = 1e-100
    J_T_takes_tau: bool = False
    chi_takes_tau: bool = False
    has_targets: bool = False
    # propagator per direction, normalized: "expprop", "cheby" or "newton"
    # (fw_/bw_/grad_prop_method default to prop_method)
    prop_method: str = "expprop"
    fw_prop_method: str = "expprop"
    bw_prop_method: str = "expprop"
    grad_prop_method: str = "expprop"
    cheby_tol: float = 1e-14
    newton_m: int = 30
    newton_substeps: int = 1
    storage_mode: str = "full"
    # segments of storage_mode="recompute" (0 under full storage)
    storage_segments: int = 0
    # keep the forward propagators for the co-state chain of the taylor
    # pass: "auto" (while the stream fits 4 GiB), True or False
    reuse_propagators: Any = "auto"
    # time-vectorized backward passes; False takes the per-step pass
    vectorize_backward: bool = True
    ctl_idx: tuple = ()  # static control index per term (None = locked)
    # per-evaluation observables: fw_prop_callback(values, tlist) with
    # values the observables (Psi (K, d), tlist, n) -> array over the grid
    # points, or the states themselves
    fw_prop_callback: Callable = None
    fw_prop_observables: tuple = ()
    # nonlinear amplitude slots ((j, CustomAmplitude, ctl_indices), ...):
    # their coefficient and ∂a/∂ε columns are evaluated per evaluation
    custom_terms: tuple = ()
    # all trajectories evolve under the SAME generator (gate optimization:
    # K basis states, one H) — U_n is computed once per step, not per k;
    # H0/ops then hold ONE entry
    shared_generator: bool = False
    # heterogeneous ensembles whose members share the control coupling
    # structure but differ in amplitude SHAPES: M/Mfix carry a leading
    # per-trajectory K axis
    per_traj_coeffs: bool = False
    # contiguous-run generator grouping (gate ensembles: each sample's
    # n_basis trajectories share ONE generator object): the expm and the
    # Fréchet base are derived once per (step, group).  1 = no grouping.
    gen_group_size: int = 1
    # operator STORAGE layout: True = H0/ops hold ONE entry per generator
    # group (K/gen_group_size entries) instead of one per trajectory
    ops_grouped: bool = False
    # host-side operator norms cached at compile time:
    # {"h0": ||H0||_1, "ops": (T,) per-term ||Op_j||_1} and, where a
    # direction is Chebyshev, "spec": {"eig_lo", "eig_hi" (per entry),
    # "op2" (per entry and term, 2-norms)}
    norm_cache: Any = None
    # memo for the host-side coefficient envelope (keyed by amp_max)
    env_cache: Any = field(default_factory=dict)
    device: Any = None
    # set by parallel.shard_problem on one rank's block of trajectories:
    # the DeviceMesh and its trajectory axis, the block's rows
    # [start, stop) of the ensemble, and the whole problem (its
    # trajectories and targets for J_T and χ(T), its coefficient tables
    # for the amplitude envelope)
    mesh: Any = None
    mesh_axis: Any = None
    traj_rows: Any = None
    global_problem: Any = None
    # the reference's kernel switch: "auto" or True (the hand-written
    # kernels on CUDA in complex64, their plain versions for CPU tensors)
    # or False (no kernel: the plain PyTorch path complex128 takes)
    use_pallas: Any = "auto"
    # the reference's precision of its Fréchet kernel's products; the
    # port's Fréchet kernels meet every value with float32 FMAs
    gradgen_pallas_precision: str = "high"

    @property
    def dt(self):
        return np.diff(self.tlist)


# the values the reference takes for the precision of its Fréchet kernel
_PRECISIONS = ("high", "highest", "default")


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


def _prop_methods(prop_method, fw_prop_method, bw_prop_method,
                  grad_prop_method):
    """The normalized ``(prop, fw, bw, grad)`` methods: each direction's
    own setting, else ``prop_method`` (the reference's override chain)."""
    return tuple(
        _normalize_prop_method(prop_method if m is None else m)
        for m in (None, fw_prop_method, bw_prop_method, grad_prop_method)
    )


_PROP_SETTING_KEYS = (
    "prop_method", "fw_prop_method", "bw_prop_method", "grad_prop_method"
)


def _merge_traj_prop_settings(trajectories, *given):
    """The propagator settings ``(prop, fw, bw, grad)`` (unnormalized, None
    where not given) after reading the trajectories' attributes of the same
    names (the reference's rule, ``grape_tpu/fg.py:489-540``).  A setting
    carried uniformly by every trajectory is adopted, and so is one that
    only some carry when it equals what the others resolve to.  A setting
    that differs between trajectories raises ``NotImplementedError``: one
    compiled problem propagates every trajectory alike, and ``optimize``
    partitions such an ensemble (``fg_hetero``).  A trajectory setting
    that conflicts with the global keyword raises ``ValueError``."""
    out = list(given)
    K = len(trajectories)
    for i, key in enumerate(_PROP_SETTING_KEYS):
        vals = [
            t.kwargs[key] for t in trajectories
            if getattr(t, "kwargs", None) and key in t.kwargs
        ]
        if not vals:
            continue
        norm = {_normalize_prop_method(v) for v in vals}
        # what the trajectories WITHOUT the attribute resolve to: the
        # global keyword, falling back to prop_method, then the default
        base = out[i]
        if base is None and key != "prop_method":
            base = out[0]
        eff_default = _normalize_prop_method(base)
        partial_hetero = len(vals) < K and norm != {eff_default}
        if len(norm) > 1 or partial_hetero:
            raise NotImplementedError(
                "per-trajectory-heterogeneous propagator settings in a "
                "single compiled problem are not supported: trajectories "
                f"specify {key} in {sorted(norm)} ({len(vals)}/{K} "
                "trajectories carry the attribute).  Use optimize(), which "
                "partitions such ensembles into uniform problems with the "
                "functional assembled over all of them "
                "(fg_hetero.compile_heterogeneous), or pass one global "
                f"{key}= here"
            )
        val = vals[0]
        base = out[i]
        if base is not None and (
            _normalize_prop_method(base) != _normalize_prop_method(val)
        ):
            raise ValueError(
                f"trajectory attribute {key}={val!r} conflicts with "
                f"the global {key}={base!r} keyword argument"
            )
        out[i] = val
    return tuple(out)


def _check_options(gradient_method, storage_mode, use_pallas,
                   gradgen_pallas_precision):
    """Raise ``ValueError`` for a value no entry point takes."""
    if gradient_method not in ("gradgen", "taylor", "auto"):
        raise ValueError(
            f"Unknown gradient_method: {gradient_method!r} "
            "(supported: 'gradgen', 'taylor', 'auto')"
        )
    if storage_mode not in ("full", "recompute"):
        raise ValueError(
            f"Unknown storage_mode: {storage_mode!r} "
            "(supported: 'full', 'recompute')"
        )
    if not (isinstance(use_pallas, (bool, np.bool_))
            or (isinstance(use_pallas, str) and use_pallas == "auto")):
        raise ValueError(
            f"Unknown use_pallas: {use_pallas!r} (supported: 'auto', "
            "True, False)"
        )
    if gradgen_pallas_precision not in _PRECISIONS:
        raise ValueError(
            f"unknown precision {gradgen_pallas_precision!r} (supported: "
            f"{', '.join(map(repr, _PRECISIONS))})"
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
    g_b=None,
    xi=None,
    lambda_b=1.0,
    gradient_method="gradgen",
    taylor_grad_max_order=100,
    taylor_grad_tolerance=1e-16,
    taylor_grad_check_convergence=True,
    chi_min_norm=1e-100,
    dtype=None,
    prop_method=None,
    fw_prop_method=None,
    bw_prop_method=None,
    grad_prop_method=None,
    cheby_tol=1e-14,
    newton_m=30,
    newton_substeps=1,
    storage_mode="full",
    storage_segments=None,
    reuse_propagators="auto",
    vectorize_backward=True,
    fw_prop_callback=None,
    fw_prop_observables=None,
    use_pallas="auto",
    gradgen_pallas_precision="high",
    device=None,
    _controls=None,
):
    """Compile trajectories + tlist into a :class:`CompiledProblem`.

    Extract the distinct controls, discretize them on the interval
    midpoints into the guess pulse vector, stack the trajectory data along
    the batch axis, and build the static per-interval coefficient tensor
    ``M`` — the same arrays the reference's ``compile_problem`` builds.

    ``device=None`` means the CUDA device (and raises without one);
    ``dtype=None`` means complex64 there and complex128 on the CPU.
    ``gradient_method="auto"`` resolves as in the reference: gradgen
    wherever its time-vectorized pass serves (ExpProp in every direction,
    ``dim ≤ 128`` and a feasible co-state chain), else taylor.  The
    propagator of each direction is ``fw_prop_method`` / ``bw_prop_method``
    / ``grad_prop_method`` where given, else ``prop_method`` (``None``:
    ExpProp); ``cheby_tol`` truncates the Chebyshev series, ``newton_m`` and
    ``newton_substeps`` size the Krylov one.  ``g_b`` (with ``xi``, else
    its ``make_xi``) adds the state running cost ``λ_b·J_b``;
    ``storage_mode="recompute"`` keeps ``storage_segments`` (default: the
    divisor of N_T nearest √N_T) checkpoints instead of every state;
    ``fw_prop_callback`` (full storage only) receives the per-step
    ``fw_prop_observables`` once per evaluation.  Propagator settings
    carried by the trajectories are merged by
    :func:`_merge_traj_prop_settings`.  ``_controls`` (the heterogeneous
    compile's) gives the GLOBAL control list, so that every partition of an
    ensemble shares one pulse layout; a control that a partition's
    generators do not couple to gets zero columns.  An unknown keyword
    raises ``TypeError``.

    The reference's two kernel switches: ``use_pallas="auto"`` (the
    default) and ``True`` run the hand-written kernels where the problem is
    complex64 on CUDA, and their plain PyTorch versions for CPU tensors
    (``True`` on the CPU is the counterpart of the reference's interpret
    mode); ``False`` runs no hand-written kernel, the plain PyTorch path
    that complex128 takes (the counterpart of the reference's XLA path).
    ``False`` is taken only when asked for: a kernel that fails to build or
    launch still raises under the other two.  ``gradgen_pallas_precision``
    (``"high"``, ``"highest"`` or ``"default"``) chooses how many bf16
    passes the reference's Fréchet kernel makes a product; the port's
    Fréchet kernels use float32 FMAs, which meet each value as a floor on
    precision, and do matrix-vector work (the factored kernel) that no
    one-pass tensor-core product would speed up, so all three run the same
    arithmetic.  Any other value of either raises ``ValueError``; an
    unknown precision raises here, where the reference raises when its
    kernel is traced.
    """
    device = resolve_device(device)
    _check_options(gradient_method, storage_mode, use_pallas,
                   gradgen_pallas_precision)
    trajectories = list(trajectories)
    tlist = np.asarray(tlist, dtype=np.float64)
    N_T = len(tlist) - 1
    K = len(trajectories)
    if K == 0:
        raise ValueError("no trajectories")
    methods = _prop_methods(*_merge_traj_prop_settings(
        trajectories, prop_method, fw_prop_method, bw_prop_method,
        grad_prop_method))

    generators = [t.generator for t in trajectories]
    controls = (tuple(_controls) if _controls is not None
                else get_controls(generators))
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
        dtype = default_complex(device)
    cdtype = complex_dtype(numpy_dtype(dtype))

    # Heterogeneous ensembles: the batched design needs slot-aligned term
    # lists (same count, same control coupling per slot).  Generators that
    # differ structurally (a robustness ensemble where only some members
    # carry a crosstalk drive) are aligned to the union of their amplitudes
    # with zero-operator padding.
    if not _slots_aligned(generators, controls):
        generators = align_generators(generators)
    g0 = generators[0]
    n_terms = len(g0.terms)
    dim = g0.dim
    ctl_idx = g0.term_control_indices(controls)
    # nonlinear amplitude slots (identical across k after alignment)
    custom_terms = tuple(g0.custom_terms(controls))

    # Coefficient tensor M (N_T, T, L): term j couples to control l_j with
    # per-interval weight shape_j[n]; locked terms go to Mfix.  Where the
    # trajectories differ in their amplitude SHAPES (same control, another
    # static weight), M/Mfix grow a leading K axis.
    coeff_tables = [g.coefficient_tables(tlist, controls)
                    for g in generators]
    M, Mfix = coeff_tables[0]
    per_traj_coeffs = any(
        not (np.array_equal(Mk, M) and np.array_equal(Mfk, Mfix))
        for (Mk, Mfk) in coeff_tables[1:]
    )
    if per_traj_coeffs:
        M = np.stack([Mk for (Mk, _) in coeff_tables])      # (K, N_T, T, L)
        Mfix = np.stack([Mfk for (_, Mfk) in coeff_tables])  # (K, N_T, T)

    # gate-optimization detection: one generator, K basis states.  Shared
    # operator arrays are stored with a LENGTH-1 leading axis; contiguous
    # runs of one generator OBJECT (gate ensembles: each sample's basis
    # states share one generator) store ONE entry per group.
    same_gen = all(g is g0 for g in generators)
    grun = 1
    if not same_gen and not per_traj_coeffs:
        grun = _gen_group_runs(generators)
        if grun <= 1 or K % grun != 0:
            grun = 1
    if same_gen and not per_traj_coeffs:
        stack_gens = generators[:1]
    elif grun > 1:
        stack_gens = generators[::grun]
    else:
        stack_gens = generators
    H0 = np.stack([g.drift for g in stack_gens]).astype(cdtype)
    if n_terms > 0:
        ops = np.stack(
            [np.stack([op for (op, _) in g.terms]) for g in stack_gens]
        ).astype(cdtype)  # (K, groups, or 1, T, d, d)
    else:
        ops = np.zeros((len(stack_gens), 0, dim, dim), dtype=cdtype)
    shared_generator = not per_traj_coeffs and (
        same_gen
        or (bool(np.all(H0 == H0[:1])) and bool(np.all(ops == ops[:1])))
    )
    if shared_generator and H0.shape[0] > 1:
        H0 = np.ascontiguousarray(H0[:1])
        ops = np.ascontiguousarray(ops[:1])
    ops_grouped = grun > 1 and not shared_generator

    psi0 = np.stack([t.initial_state for t in trajectories]).astype(cdtype)
    has_targets = all(t.target_state is not None for t in trajectories)

    if chi is None:
        chi = make_chi(J_T, trajectories)
    if J_a is not None and grad_J_a is None:
        grad_J_a = make_grad_J_a(J_a, tlist)
    g_b, xi = _running_cost_closures(g_b, xi, lambda_b, trajectories)

    rdtype = real_dtype(cdtype)
    cp = CompiledProblem(
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
        g_b=g_b,
        xi=xi,
        lambda_b=float(lambda_b),
        gradient_method=(
            "gradgen" if gradient_method == "auto" else gradient_method
        ),
        taylor_grad_max_order=int(taylor_grad_max_order),
        taylor_grad_tolerance=float(taylor_grad_tolerance),
        taylor_grad_check_convergence=bool(taylor_grad_check_convergence),
        chi_min_norm=float(chi_min_norm),
        J_T_takes_tau=accepts_tau(J_T) and has_targets,
        chi_takes_tau=accepts_tau(chi) and has_targets,
        has_targets=has_targets,
        prop_method=methods[0],
        fw_prop_method=methods[1],
        bw_prop_method=methods[2],
        grad_prop_method=methods[3],
        cheby_tol=float(cheby_tol),
        newton_m=int(newton_m),
        newton_substeps=int(newton_substeps),
        storage_mode=storage_mode,
        storage_segments=_pick_segments(storage_mode, storage_segments, N_T),
        reuse_propagators=reuse_propagators,
        vectorize_backward=bool(vectorize_backward),
        ctl_idx=tuple(ctl_idx),
        fw_prop_callback=_check_fw_prop_callback(fw_prop_callback,
                                                 storage_mode),
        fw_prop_observables=tuple(fw_prop_observables or ()),
        custom_terms=custom_terms,
        shared_generator=shared_generator,
        per_traj_coeffs=per_traj_coeffs,
        # identity-run grouping stores group-level arrays; equal arrays
        # under distinct objects keep per-trajectory storage
        gen_group_size=(
            grun if ops_grouped else _detect_gen_group_size(
                trajectories, H0, ops, per_traj_coeffs, shared_generator,
            )
        ),
        ops_grouped=ops_grouped,
        use_pallas=(use_pallas if isinstance(use_pallas, str)
                    else bool(use_pallas)),
        gradgen_pallas_precision=gradgen_pallas_precision,
        norm_cache=_make_norm_cache(H0, ops,
                                    with_spectral="cheby" in methods),
        device=device,
    )
    if gradient_method == "auto":
        _resolve_auto_gradient_method(cp)
    return cp


def _running_cost_closures(g_b, xi, lambda_b, trajectories):
    """``(g_b, xi)`` as the reference settles them, with its warnings:
    ``g_b`` under ``lambda_b = 0`` is dropped, a missing ``xi`` is derived
    from ``g_b`` (:func:`make_xi`), an ``xi`` without ``g_b`` is dropped."""
    g_b_given = g_b is not None
    if lambda_b == 0 and g_b is not None:
        warnings.warn("Argument `g_b` was given with `lambda_b = 0.0`. Ignoring")
        g_b = None
        xi = None
    if g_b is not None and xi is None:
        xi = make_xi(g_b, trajectories)
    if not g_b_given and xi is not None:
        warnings.warn("Argument `xi` was given without `g_b`. Ignoring")
        xi = None
    return g_b, xi


def _pick_segments(storage_mode, storage_segments, N_T):
    """Segment count of checkpoint/recompute storage: ``storage_segments``
    (which must divide N_T), else the divisor of N_T nearest √N_T (memory
    about 2·√N_T states instead of N_T); 0 under full storage."""
    if storage_mode != "recompute":
        return 0
    if storage_segments:
        if N_T % int(storage_segments) != 0:
            raise ValueError(
                f"storage_segments ({storage_segments}) must divide the "
                f"number of time steps ({N_T})"
            )
        return int(storage_segments)
    target = max(1, int(np.sqrt(N_T)))
    divisors = [s for s in range(1, N_T + 1) if N_T % s == 0]
    return min(divisors, key=lambda s: abs(s - target))


def _check_fw_prop_callback(fw_prop_callback, storage_mode):
    if fw_prop_callback is not None and storage_mode == "recompute":
        raise ValueError(
            "fw_prop_callback requires storage_mode='full' (the recompute "
            "mode does not materialize the per-step forward states)"
        )
    return fw_prop_callback


def _resolve_auto_gradient_method(cp):
    """``gradient_method="auto"`` (the reference's rule, kept whatever this
    card's own timings say so that both packages route a problem alike):
    gradgen wherever the time-vectorized rank-1 Fréchet pass serves
    (ExpProp in every direction, full storage, ``dim ≤ 128``, a feasible
    co-state chain), else taylor: a Chebyshev or Krylov direction means
    taylor.  ``cp.gradient_method`` holds ``"gradgen"`` on entry."""
    if cp.dim > 128 or not _vec_gradgen_enabled(cp):
        cp.gradient_method = "taylor"


def _gen_group_runs(gens):
    """Contiguous identical-object run length if uniform, else 1."""
    runs = []
    cur = 1
    for a, b in zip(gens, gens[1:]):
        if b is a:
            cur += 1
        else:
            runs.append(cur)
            cur = 1
    runs.append(cur)
    g = runs[0]
    if g > 1 and all(r == g for r in runs):
        return g
    return 1


def _detect_gen_group_size(trajectories, H0, ops, per_traj_coeffs,
                           shared_generator):
    """Group size where the operators are stored per trajectory:
    contiguous runs of trajectories sharing one generator (verified against
    the stacked operator arrays)."""
    if shared_generator or per_traj_coeffs:
        return 1
    K = len(trajectories)
    g = _gen_group_runs([t.generator for t in trajectories])
    if g <= 1 or K % g != 0:
        return 1
    H0v = H0.reshape(K // g, g, *H0.shape[1:])
    opsv = ops.reshape(K // g, g, *ops.shape[1:])
    if not (
        bool(np.all(H0v == H0v[:, :1]))
        and bool(np.all(opsv == opsv[:, :1]))
    ):
        return 1
    return g


def _slots_aligned(generators, controls):
    """True when all generators share a slot-aligned term structure: same
    dimension, same term count, slot-wise the same control coupling, and
    slot-wise the SAME object for nonlinear (CustomAmplitude) slots.
    Linear slots may differ in amplitude shape/operator across
    trajectories (handled by per-trajectory coefficient tables)."""
    g0 = generators[0]
    idx0 = g0.term_control_indices(controls)
    for g in generators[1:]:
        if g.dim != g0.dim or len(g.terms) != len(g0.terms):
            return False
        if g.term_control_indices(controls) != idx0:
            return False
        for (_, a), (_, a0) in zip(g.terms, g0.terms):
            c, c0 = (isinstance(a, CustomAmplitude),
                     isinstance(a0, CustomAmplitude))
            if c != c0 or (c and a is not a0):
                return False
    return True


def _make_norm_cache(H0, ops, with_spectral=False):
    """Host-side operator 1-norms captured at compile time and, for a
    Chebyshev direction, the spectral data of each operator entry: the
    extreme eigenvalues of the drift's Hermitian part and the 2-norm of
    every term (the reference's numpy calls, on the same arrays)."""
    K = H0.shape[0]
    cache = {
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
    if with_spectral:
        eig_lo = np.empty(K)
        eig_hi = np.empty(K)
        op2 = np.empty((K, ops.shape[1]))
        for k in range(K):
            w = np.linalg.eigvalsh(0.5 * (H0[k] + H0[k].conj().T))
            eig_lo[k], eig_hi[k] = w[0], w[-1]
            for j in range(ops.shape[1]):
                op2[k, j] = np.linalg.norm(ops[k, j], 2)
        cache["spec"] = {"eig_lo": eig_lo, "eig_hi": eig_hi, "op2": op2}
    return cache


# --------------------------------------------------------------------------
# Host-side amplitude envelope -> static squaring count
# --------------------------------------------------------------------------

def _default_amp_max(cp: CompiledProblem):
    return np.maximum(np.max(np.abs(cp.guess_pulsevals), axis=1), 0.1)


def _coeff_env(cp: CompiledProblem, amp_max):
    """Host-side envelope of the per-interval coefficients and their
    control derivatives over the pulse box ``|ε_l| ≤ amp_max_l``:
    ``(cmax (T,), dmax (T, L))`` numpy.  A ``CustomAmplitude`` slot takes
    its analytic ``bound`` or, without one, a sampled envelope
    (:func:`_sample_amp_env`).  Memoized per ``amp_max``."""
    if cp.global_problem is not None:
        # a rank's block: the envelope of the whole ensemble's tables, so
        # that every rank and the unsharded build size alike
        return _coeff_env(cp.global_problem, amp_max)
    amp_max = np.asarray(amp_max, dtype=np.float64)
    key = tuple(amp_max.ravel().tolist())
    if key in cp.env_cache:
        return cp.env_cache[key]
    absM = np.abs(np.asarray(cp.M))
    absMfix = np.abs(np.asarray(cp.Mfix))
    if cp.per_traj_coeffs:
        cmax = (
            np.einsum("kntl,l->knt", absM, amp_max) + absMfix
        ).max(axis=(0, 1))
        dmax = absM.max(axis=(0, 1))
    else:
        cmax = (np.einsum("ntl,l->nt", absM, amp_max) + absMfix).max(axis=0)
        dmax = absM.max(axis=0)
    for j, amp, idxs in cp.custom_terms:
        sub = amp_max[list(idxs)]
        if amp.bound is not None:
            ca, da = amp.bound(sub)
        else:
            if not getattr(amp, "_env_sample_warned", False):
                warnings.warn(
                    "CustomAmplitude envelope is being SAMPLED (17-point"
                    " grids / 256 random points x 1.25 margin): a spiky"
                    " amplitude between samples can under-size the"
                    " static Taylor order (the honest last-term check"
                    " catches divergence at the cost of a rebuild)."
                    "  Supply CustomAmplitude(bound=...) for an analytic"
                    " envelope if a(eps, t) has high curvature."
                )
                amp._env_sample_warned = True
            ca, da = _sample_amp_env(amp, sub, np.asarray(cp.tlist))
        cmax[j] = float(ca)
        dmax[j, :] = 0.0
        dmax[j, list(idxs)] = np.asarray(da, dtype=np.float64).reshape(-1)
    cp.env_cache[key] = (cmax, dmax)
    return cmax, dmax


def _sample_amp_env(amp, amp_max, tlist, margin=1.25):
    """Envelope of ``|a|`` and ``|∂a/∂ε|`` for a CustomAmplitude by
    sampling the pulse box (×``margin``; an over-estimate only costs extra
    Taylor orders or squarings): a 17-point grid per control for one or
    two controls, else 256 random points, 64 corners, the axes and the
    origin; at most 33 of the interval times.  The same points as the
    reference, evaluated with ``torch.func`` on the CPU in the precision of
    the inputs."""
    n = len(amp_max)
    amp_max = np.maximum(np.asarray(amp_max, dtype=np.float64), 1e-12)
    if n <= 2:
        axes = [np.linspace(-a, a, 17) for a in amp_max]
        pts = np.array(list(itertools.product(*axes)))
    else:
        rng = np.random.default_rng(0)
        pts = np.concatenate([
            rng.uniform(-1.0, 1.0, size=(256, n)) * amp_max,
            np.where(rng.uniform(size=(64, n)) < 0.5, -1.0, 1.0) * amp_max,
            np.diag(amp_max),
            -np.diag(amp_max),
            np.zeros((1, n)),
        ])
    tmid = midpoints(tlist)
    if len(tmid) > 33:
        tmid = tmid[np.linspace(0, len(tmid) - 1, 33).astype(int)]
    dfun = amp.deriv
    if dfun is None:
        dfun = torch.func.jacfwd(amp.func, argnums=0)
    vmap = torch.func.vmap
    fv = vmap(vmap(amp.func, in_dims=(0, None)), in_dims=(None, 0))
    dv = vmap(vmap(dfun, in_dims=(0, None)), in_dims=(None, 0))
    P = torch.as_tensor(pts)
    Tm = torch.as_tensor(np.asarray(tmid))
    with torch.no_grad():
        av = fv(P, Tm).numpy()            # (n_t, n_pts)
        gv = np.abs(dv(P, Tm).numpy())    # (n_t, n_pts, n)
    ca = float(np.max(np.abs(av)))
    da = gv.reshape(-1, n).max(axis=0)
    return margin * ca, margin * da


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


def _mu_norm_bound(cp: CompiledProblem, amp_max=None):
    """Host-side bound on ``max_{n,l,k} ‖μ_knl‖_1`` with
    ``μ_nl = Σ_j (∂a_j/∂ε_l)·Op_j`` over the pulse envelope (for linear
    amplitudes ``∂a_j/∂ε_l = M[n,j,l]``, amplitude-independent)."""
    if np.asarray(cp.M).shape[-2] == 0 or cp.n_controls == 0:
        return 0.0
    if amp_max is None:
        amp_max = 2.0 * _default_amp_max(cp)
    _, dmax = _coeff_env(cp, amp_max)  # (T, L)
    _, opn = _op_norms(cp)
    return float(np.einsum("tl,t->l", dmax, opn).max())


def _taylor_prefactor(cp: CompiledProblem, amp_max=None):
    """``‖μ‖/‖H‖`` prefactor for the static Taylor-order bound (see
    ``taylor_order_for_bound``)."""
    return (
        _mu_norm_bound(cp, amp_max)
        / max(_h_norm_bound(cp, amp_max), 1e-30)
    )


def _taylor_tol_effective(cp: CompiledProblem):
    """Effective tolerance for the static-order Taylor pass: the user's
    tolerance, floored at 1e-9 for complex64 (float32 terms below about
    1e-9·‖H·dt‖ are numeric noise; demanding them would fail the honest
    last-term check for no reason)."""
    tol = cp.taylor_grad_tolerance
    if np.dtype(cp.psi0.dtype) == np.complex64:
        tol = max(tol, 1e-9)
    return tol


def _reuse_U_enabled(cp: CompiledProblem):
    """Keep the forward step propagators ``U_n`` for the backward co-state
    propagation of the taylor gradient (``χ ← U_n†χ``, an exact identity),
    where forward and backward propagation are ExpProp.  ``"auto"`` gates
    on the storage cost ``N_T·K·d²`` (one entry for a shared generator;
    under recompute the steps of ONE segment) staying within 4 GiB.  The
    reference has one more
    clause, for its TPU platform only, where collecting per-trajectory
    propagators from a scan that is not a kernel was slower than forming
    them again; it is dropped here: on the card every forward path emits U
    as it goes."""
    if cp.reuse_propagators is False:
        return False
    if cp.fw_prop_method != "expprop" or cp.bw_prop_method != "expprop":
        return False
    if cp.gradient_method != "taylor":
        return False
    if cp.reuse_propagators == "auto":
        n_stored = cp.n_timesteps
        if cp.storage_mode == "recompute" and cp.storage_segments:
            n_stored = cp.n_timesteps // cp.storage_segments  # per segment
        k_u = 1 if cp.shared_generator else cp.n_traj
        nbytes = (
            n_stored * k_u * cp.dim * cp.dim
            * np.dtype(cp.psi0.dtype).itemsize
        )
        return nbytes <= 4 * 1024**3
    return bool(cp.reuse_propagators)


def _vectorized_taylor_orders(cp: CompiledProblem, amp_max=None):
    """Static Taylor order count for the time-vectorized backward pass,
    from the host amplitude envelope (plus the ‖μ‖/‖H‖ prefactor and a +2
    margin).  None when no order within ``taylor_grad_max_order`` reaches
    the tolerance: the caller then takes the per-step pass with its own
    convergence check."""
    return taylor_order_for_bound(
        _step_norm_bound(cp, amp_max),
        tolerance=_taylor_tol_effective(cp),
        max_order=cp.taylor_grad_max_order,
        prefactor=_taylor_prefactor(cp, amp_max),
    )


def uses_static_envelope(cp: CompiledProblem):
    """True when the evaluations derive STATIC data from the
    pulse-amplitude envelope: the Chebyshev tables, the kernels' squaring
    count, the squaring count of the vectorized gradgen pass, or the order
    count of the vectorized Taylor pass.  The workspace then grows its
    envelope bucket (and builds the tables again) when the optimizer
    pushes a pulse past it.  Unlike the reference, whose forward kernels
    are off under recompute, the port runs each recomputed segment through
    the forward kernels, so their clause holds in both storage modes.  A
    heterogeneous problem asks each of its partitions."""
    if hasattr(cp, "parts"):  # heterogeneous compile
        return any(uses_static_envelope(p) for p in cp.parts)
    if "cheby" in (cp.fw_prop_method, cp.bw_prop_method,
                   cp.grad_prop_method):
        return True
    if _kernels_enabled(cp):
        return True
    if cp.gradient_method == "taylor" and cp.vectorize_backward:
        return True
    return _vec_gradgen_enabled(cp)


def _kernels_enabled(cp: CompiledProblem):
    """The kernel wrappers (and, for CPU tensors, their plain versions)
    serve complex64, as the TPU kernels are gated on it, unless
    ``use_pallas=False``; complex128 and ``use_pallas=False`` take the
    plain path (Padé-13 in complex128, the degree-16 Taylor polynomial in
    complex64)."""
    return (cp.use_pallas is not False
            and np.dtype(cp.psi0.dtype) == np.complex64)


def _effective_group_size(cp: CompiledProblem):
    """Group size the grouped compute paths use: the detected contiguous
    generator groups, 1 where the tables differ per trajectory."""
    gs = cp.gen_group_size or 1
    if gs <= 1 or cp.per_traj_coeffs or cp.n_traj % gs != 0:
        return 1
    return gs


def _group_ops(cp: CompiledProblem, H0, ops):
    """Operator arrays with ONE entry per generator group."""
    if cp.ops_grouped:
        return H0, ops
    gs = _effective_group_size(cp)
    if gs > 1:
        return H0[::gs], ops[::gs]
    return H0, ops


def _pertraj_ops(cp: CompiledProblem, H0, ops):
    """Operator arrays with ONE entry per trajectory, expanding group-level
    storage by repetition."""
    if cp.ops_grouped:
        gs = cp.gen_group_size
        return np.repeat(H0, gs, axis=0), np.repeat(ops, gs, axis=0)
    return H0, ops


def _stored_u_entries(cp: CompiledProblem):
    """Per-step stored-propagator count: 1 for a shared generator, one per
    GROUP for grouped generators, K otherwise."""
    if cp.shared_generator:
        return 1
    return cp.n_traj // _effective_group_size(cp)


def _gg_u_bytes_ok(cp: CompiledProblem):
    """U-storage bound for the stored-propagator phase A of the vectorized
    gradgen pass (``N_T · k_u · d²`` complex entries)."""
    nbytes = (
        cp.n_timesteps * _stored_u_entries(cp) * cp.dim * cp.dim
        * np.dtype(cp.psi0.dtype).itemsize
    )
    return nbytes <= 4 * 1024**3


def _all_expprop(cp: CompiledProblem):
    """Forward, backward and gradient propagation are all ExpProp (the
    formulation the stored-propagator and Fréchet paths need)."""
    return (cp.fw_prop_method == "expprop" and cp.bw_prop_method == "expprop"
            and cp.grad_prop_method == "expprop")


def _vec_gradgen_enabled(cp: CompiledProblem):
    """The time-vectorized gradgen backward pass: asked for (gradgen,
    ``vectorize_backward``, propagator reuse not refused), ExpProp in every
    direction, and with a feasible phase A: a propagator stream within its
    budget, or the kernels, whose co-state chain can form the propagators
    again.  Under recompute the pass runs segment by segment, where phase A
    is always feasible (per-segment stored or re-formed propagators)."""
    if not cp.vectorize_backward or cp.gradient_method != "gradgen":
        return False
    if cp.reuse_propagators is False or not _all_expprop(cp):
        return False
    if cp.storage_mode == "recompute":
        return True
    return _gg_u_bytes_ok(cp) or _kernels_enabled(cp)


def _seg_reuse_U(cp: CompiledProblem):
    """Keep the propagators of ONE recomputed segment for its co-state
    chain (the segment-vectorized backward of recompute storage): ExpProp
    everywhere, reuse not refused, and a segment block of
    ``seg_len · k_u · d²`` complex entries (one per generator group) within
    4 GiB; beyond it phase A forms the propagators again."""
    if cp.reuse_propagators is False or not _all_expprop(cp):
        return False
    seg_len = cp.n_timesteps // max(cp.storage_segments, 1)
    nbytes = (
        seg_len * _stored_u_entries(cp) * cp.dim * cp.dim
        * np.dtype(cp.psi0.dtype).itemsize
    )
    return nbytes <= 4 * 1024**3


def _smalld_enabled(cp: CompiledProblem):
    """The small-dimension forward kernel (``forward_scan_smalld``), under
    the reference's gates so that both packages route a problem alike: the
    kernels' precision, ExpProp forward, full storage, one generator per
    trajectory at ``d ≤ 4``, at least 128 trajectories, one coefficient
    table.  It does not look at the gradient method."""
    return (
        _kernels_enabled(cp) and cp.fw_prop_method == "expprop"
        and cp.storage_mode != "recompute"
        and not cp.shared_generator
        and not cp.per_traj_coeffs and cp.dim <= SMALLD_MAX_DIM
        and cp.n_traj >= SMALLD_MIN_TRAJ
    )


def _compute_group_size(cp: CompiledProblem):
    """Trajectories per operator entry as the compute paths see them: the
    effective group size, but 1 on the small-dimension route, whose kernel
    takes one generator per trajectory."""
    return 1 if _smalld_enabled(cp) else _effective_group_size(cp)


# --------------------------------------------------------------------------
# Chebyshev and Krylov propagator data
# --------------------------------------------------------------------------

def _cheby_data(cp: CompiledProblem, amp_max):
    """Static Chebyshev data for a pulse-amplitude envelope ``amp_max (L,)``
    (the reference's ``_cheby_data``): the spectral envelope of the
    generators over the envelope, from the compile-time ``spec`` cache or
    by :func:`spectral_envelope`, and per step the Bessel coefficient rows
    of the forward and backward series (padded with zeros to one width)
    and the overall phases.  Host numpy in float64, the tables cast to the
    problem's dtype."""
    amp_max = np.asarray(amp_max, dtype=np.float64)
    cmax, _ = _coeff_env(cp, amp_max)  # (T,)
    spec = (cp.norm_cache or {}).get("spec")
    if spec is not None:
        lo = spec["eig_lo"] - spec["op2"] @ cmax  # (entries,)
        hi = spec["eig_hi"] + spec["op2"] @ cmax
        E_min, E_max = float(lo.min()), float(hi.max())
        span = max(E_max - E_min, 1e-12)
        E_min, E_max = E_min - 0.05 * span, E_max + 0.05 * span
    else:
        E_min, E_max = spectral_envelope(
            np.asarray(cp.H0), np.asarray(cp.ops), -cmax, cmax
        )
    dE = E_max - E_min
    shift = E_max + E_min  # normalization H_norm = (2H - shift)/dE
    dt = np.diff(np.asarray(cp.tlist, dtype=np.float64))
    rows_fw, rows_bw, ph_fw, ph_bw = [], [], [], []
    for dtn in dt:
        alpha = 0.5 * dE * dtn
        rows_fw.append(cheby_coeffs(alpha, tol=cp.cheby_tol))
        rows_bw.append(cheby_coeffs(-alpha, tol=cp.cheby_tol))
        # overall phase e^{-i (dE/2 + E_min) dt} (forward), conj backward
        ph = np.exp(-1j * 0.5 * (E_max + E_min) * dtn)
        ph_fw.append(ph)
        ph_bw.append(np.conj(ph))
    Kt = max(max(len(r) for r in rows_fw), max(len(r) for r in rows_bw))
    tab_fw = np.zeros((len(dt), Kt), dtype=np.complex128)
    tab_bw = np.zeros((len(dt), Kt), dtype=np.complex128)
    for n, (rf, rb) in enumerate(zip(rows_fw, rows_bw)):
        tab_fw[n, : len(rf)] = rf
        tab_bw[n, : len(rb)] = rb
    cdtype = cp.psi0.dtype
    return {
        "dE": dE,
        "shift": shift,
        "tab_fw": np.asarray(tab_fw, dtype=cdtype),
        "tab_bw": np.asarray(tab_bw, dtype=cdtype),
        "ph_fw": np.asarray(ph_fw, dtype=cdtype),
        "ph_bw": np.asarray(ph_bw, dtype=cdtype),
    }


def _prop_data_for(cp: CompiledProblem, method, amp_max=None, cache=None):
    """The data of one direction's propagator: None for ExpProp, the
    Chebyshev tables, or the Krylov sizes; memoized in ``cache`` by
    method."""
    if cache is not None and method in cache:
        return cache[method]
    if method == "cheby":
        if amp_max is None:
            amp_max = 2.0 * _default_amp_max(cp)
        pd = _cheby_data(cp, amp_max)
        pd["kind"] = "cheby"
    elif method == "newton":
        pd = {"kind": "newton", "m": cp.newton_m,
              "substeps": cp.newton_substeps}
    else:
        pd = None
    if cache is not None:
        cache[method] = pd
    return pd


def _prop_data(cp: CompiledProblem, amp_max=None):
    """Per-direction propagator data (``"fw"``, ``"bw"``, ``"grad"``),
    built once per ``build_fg`` / ``build_f``."""
    cache = {}
    return {
        "fw": _prop_data_for(cp, cp.fw_prop_method, amp_max, cache),
        "bw": _prop_data_for(cp, cp.bw_prop_method, amp_max, cache),
        "grad": _prop_data_for(cp, cp.grad_prop_method, amp_max, cache),
        "amp_max": amp_max,
    }


def _prop_data_on(pds, device):
    """``pds`` with each Chebyshev table also as a tensor on ``device``
    (what the kernel reads) and as Python numbers (what the plain series
    multiplies by; read from the host, so a step never waits for the
    card)."""
    out = dict(pds)
    done = {}
    for key in ("fw", "bw", "grad"):
        pd = pds[key]
        if pd is None or pd["kind"] != "cheby":
            continue
        if id(pd) not in done:
            ext = dict(pd)
            for name in ("tab_fw", "tab_bw", "ph_fw", "ph_bw"):
                ext[name + "_t"] = torch.as_tensor(pd[name], device=device)
                ext[name + "_list"] = pd[name].tolist()
            done[id(pd)] = ext
        out[key] = done[id(pd)]
    return out


def _cheby_kernel_enabled(cp: CompiledProblem, pd):
    """The Chebyshev-scan kernel serves the direction whose data is ``pd``:
    the reference's gates without their TPU memory budgets: a Chebyshev
    direction, one shared generator with one coefficient table, the
    kernels on (:func:`_kernels_enabled`), ``dim ≥ 256``; and the kernel's
    own ceiling, ``dim ≤ CHEBY_MAX_DIM`` (its rows of H_n live in shared
    memory), above which the plain series runs, as the reference's scan
    does above its ceiling."""
    return (
        pd is not None and pd["kind"] == "cheby" and _kernels_enabled(cp)
        and cp.shared_generator and not cp.per_traj_coeffs
        and _CHEBY_MIN_DIM <= cp.dim <= CHEBY_MAX_DIM
    )


def _series_operator(pd, H):
    """The matrix a series step multiplies the row-vector states by, for
    generators ``H (..., d, d)``: the normalized ``H̃ᵀ`` (Chebyshev) or
    ``Hᵀ`` (Krylov)."""
    if pd["kind"] == "cheby":
        eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
        H = (2.0 * H - pd["shift"] * eye) / pd["dE"]
    return H.transpose(-1, -2)


def _series_prop(pd, opT, psi, dt_n, n, adjoint=False):
    """One step of the Chebyshev or Krylov series on the ``(G, gs, d)``
    block ``psi``, one generator per group given by its
    ``opT = _series_operator(pd, H) (G, d, d)``: forward
    ``exp(-i dt_n H) ψ``; ``adjoint`` ``exp(+i dt_n H) χ`` with ``H`` the
    adjoint generator."""
    if pd["kind"] == "newton":
        a = (1j if adjoint else -1j) * dt_n
        return arnoldi_expmv(lambda v: a * (v @ opT), psi, m=pd["m"],
                             substeps=pd["substeps"])
    key = "bw" if adjoint else "fw"
    return cheby_apply(lambda v: v @ opT, psi, pd[f"tab_{key}_list"][n],
                       pd[f"ph_{key}_list"][n])


# --------------------------------------------------------------------------
# The evaluation phases
# --------------------------------------------------------------------------

def _device_constants(cp: CompiledProblem, device):
    """The problem arrays as tensors on ``device`` (made once per build).

    ``H0 (G, d, d)`` and ``ops (G, T, d, d)`` hold one entry per group as
    the compute paths consume them: ``G = 1`` for a shared generator,
    ``K / gs`` for groups of ``gs = _compute_group_size``, else ``K``."""
    cdt = torch_dtype(cp.psi0.dtype)
    rdt = real_dtype(cdt)

    def c(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=cdt,
                               device=device)

    def r(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=rdt,
                               device=device)

    if cp.shared_generator:
        H0, ops = cp.H0[:1], cp.ops[:1]
    elif _compute_group_size(cp) > 1:
        H0, ops = _group_ops(cp, cp.H0, cp.ops)
    else:
        H0, ops = _pertraj_ops(cp, cp.H0, cp.ops)
    tl = r(cp.tlist)
    return {
        "gs": cp.n_traj // H0.shape[0], "smalld": _smalld_enabled(cp),
        "psi0": c(cp.psi0), "H0": c(H0), "ops": c(ops),
        "M": r(cp.M), "Mfix": r(cp.Mfix), "tlist": tl,
        "dt": torch.diff(tl).contiguous(), "cdtype": cdt, "rdtype": rdt,
    }


def _coeff_tables(cp: CompiledProblem, consts, eps):
    """Per-interval term coefficients and their control derivatives for
    the CURRENT pulse values ``eps (L, N_T)``: ``(coeffs (N_T, T),
    dM (N_T, T, L))``, with a leading ``K`` axis when
    ``cp.per_traj_coeffs`` (see :func:`coefficient_columns`)."""
    with span("grape.coefficients"):
        return coefficient_columns(
            consts["M"], consts["Mfix"], consts["tlist"], eps,
            cp.custom_terms, per_traj_coeffs=cp.per_traj_coeffs,
        )


def coefficient_columns(M, Mfix, tlist, eps, custom_terms,
                        per_traj_coeffs=False, derivatives=True):
    """Per-interval term coefficients for the pulse values ``eps (L, N_T)``
    from the static tables ``M (N_T, T, L)`` and ``Mfix (N_T, T)`` (a
    leading ``K`` axis with ``per_traj_coeffs``) on the grid ``tlist``
    (tensors): ``(coeffs, dM)``, ``dM`` None without ``derivatives``.
    Linear amplitudes: ``M @ ε + Mfix`` and ``M``; a ``CustomAmplitude``
    slot ``j`` of ``custom_terms`` gets ``a(ε_n, t_n)`` in its coefficient
    column and ``∂a/∂ε`` (its ``deriv``, else forward-mode AD) in its
    derivative entries, evaluated over the time grid with
    ``torch.func.vmap``, at ``t_n`` the interval midpoints except ``t_0``
    and ``t_{N_T}`` for the first and last interval."""
    if per_traj_coeffs:
        coeffs = torch.einsum("kntl,ln->knt", M, eps)
    else:
        coeffs = torch.einsum("ntl,ln->nt", M, eps)
    coeffs = coeffs + Mfix
    dM = M if derivatives else None
    if not custom_terms:
        return coeffs, dM
    n_steps = tlist.shape[0] - 1
    tmid = 0.5 * (tlist[:-1] + tlist[1:])
    tmid[0] = tlist[0]
    tmid[-1] = tlist[-1]
    tmid = tmid.to(eps.dtype)
    if derivatives:
        dM = dM.clone()  # the tables are shared by every evaluation
    vmap = torch.func.vmap
    for j, amp, idxs in custom_terms:
        idx = list(idxs)
        vals = eps[idx, :]  # (n_j, N_T)
        aj = vmap(amp.func, in_dims=(1, 0))(vals, tmid)
        aj = aj.reshape(n_steps).to(coeffs.dtype)
        if per_traj_coeffs:
            coeffs[:, :, j] = aj[None, :]
        else:
            coeffs[:, j] = aj
        if not derivatives:
            continue
        dfun = amp.deriv
        if dfun is None:
            dfun = torch.func.jacfwd(amp.func, argnums=0)
        dj = vmap(dfun, in_dims=(1, 0))(vals, tmid)
        dj = dj.reshape(n_steps, len(idx)).to(dM.dtype)
        if per_traj_coeffs:
            dM[:, :, j, idx] = dj[None]
        else:
            dM[:, j, idx] = dj
    return coeffs, dM


def _generators(consts, coeffs, sl):
    """``H (C, G, d, d)`` of the time steps ``sl`` from ``coeffs (N_T, T)``
    or, one table per group, ``(G, N_T, T)``."""
    cdt = consts["cdtype"]
    if coeffs.ndim == 3:
        term = torch.einsum("gct,gtij->cgij", coeffs[:, sl].to(cdt),
                            consts["ops"])
    else:
        term = torch.einsum("ct,gtij->cgij", coeffs[sl].to(cdt),
                            consts["ops"])
    return consts["H0"][None] + term


def _expm_steps(A):
    """``expm`` of each time step of ``A (N, G, d, d)`` with the step's OWN
    norm-derived squaring count, shared by its ``G`` matrices (what a
    per-step scan computes), batched by grouping the steps of equal
    count."""
    single = A.dtype == torch.complex64
    theta = _THETA_TAYLOR_F32 if single else _THETA13_F64
    norms = torch.amax(torch.sum(torch.abs(A), dim=-2), dim=(-2, -1))
    s = torch.clamp(
        torch.ceil(torch.log2(torch.clamp(norms, min=1e-300) / theta)),
        min=0, max=32,
    ).to(torch.int64)
    out = torch.empty_like(A)
    for val in torch.unique(s).tolist():
        idx = torch.nonzero(s == val).squeeze(-1)
        out[idx] = expm(A[idx], squarings=int(val))
    return out


def _window(cp: CompiledProblem, consts, coeffs, dM, n0, n1):
    """The per-step inputs of the time window ``n0..n1-1``: ``(consts`` with
    its ``dt`` cut to the window, ``coeffs``, ``dM)`` (``dM`` may be None).
    The phases below index these by the step within the window; where a
    global index is needed (the Chebyshev tables, the grid weights, the
    ``ξ`` and ``g_b`` closures) they are given the window's start ``n0``."""
    if n0 == 0 and n1 == cp.n_timesteps:
        return consts, coeffs, dM

    def cut(x):
        if x is None:
            return None
        return x[:, n0:n1] if cp.per_traj_coeffs else x[n0:n1]

    return dict(consts, dt=consts["dt"][n0:n1]), cut(coeffs), cut(dM)


def _forward_series(cp: CompiledProblem, consts, coeffs, pd, psi0, n0):
    """Forward propagation by the Chebyshev or Krylov series over the
    window of ``consts``/``coeffs`` starting at step ``n0``, from ``psi0``:
    ``states (C+1, K, d)``.  The Chebyshev-scan kernel where it is gated
    on (on the window's rows of the tables), else step by step (one
    generator per group, broadcast over the group's states: the
    reference's per-trajectory arithmetic)."""
    N = consts["dt"].shape[0]
    if _cheby_kernel_enabled(cp, pd):
        ys = cheby_scan(
            consts["H0"][0], consts["ops"][0],
            coeffs.to(torch.float32).contiguous(),
            pd["tab_fw_t"][n0:n0 + N].contiguous(),
            pd["ph_fw_t"][n0:n0 + N].contiguous(),
            pd["shift"], pd["dE"], psi0, adjoint=False,
        )
        return torch.cat([psi0[None], ys])
    G = consts["H0"].shape[0]
    K, d = psi0.shape
    dts = np.diff(np.asarray(cp.tlist, dtype=np.float64)).tolist()
    psi = psi0.reshape(G, K // G, d)
    states = [psi0]
    C = _gradgen_chunk(cp, n_steps=N)
    for c0 in range(0, N, C):
        opT = _series_operator(
            pd, _generators(consts, coeffs, slice(c0, c0 + C)))
        for j in range(opT.shape[0]):
            n = n0 + c0 + j
            psi = _series_prop(pd, opT[j], psi, dts[n], n)
            states.append(psi.reshape(K, d))
    return torch.stack(states)


def _forward(cp: CompiledProblem, consts, coeffs, amp_max, pds,
             want_U=True, psi0=None, n0=0):
    """Forward propagation over the window of ``consts``/``coeffs`` (the
    whole grid, or one segment starting at step ``n0``) from ``psi0``
    (default: the initial states): ``(states (C+1, K, d), Us)`` with
    ``Us (C, d, d)`` for a shared generator, ``(C, G, d, d)`` otherwise, or
    None where ``want_U`` is false and the path can do without (always
    None under a Chebyshev or Krylov forward).  A recomputed segment goes
    through the same kernel wrappers as the whole grid (a routing choice of
    the port: the reference re-propagates segments in its XLA step); each
    launch writes only the window's states."""
    if psi0 is None:
        psi0 = consts["psi0"]
    if pds["fw"] is not None:
        return _forward_series(cp, consts, coeffs, pds["fw"], psi0, n0), None
    if _kernels_enabled(cp):
        args = (
            coeffs.to(torch.float32).contiguous(),
            consts["dt"].to(torch.float32).contiguous(), psi0.contiguous(),
        )
        n_sq = _static_squarings(cp, amp_max)
        if consts["smalld"]:
            # a large ensemble of tiny systems: matrices in registers
            out = forward_scan_smalld(
                consts["H0"], consts["ops"], *args, n_sq,
                with_propagators=want_U,
            )
            return out if want_U else (out, None)
        if cp.shared_generator:
            return forward_scan_shared(
                consts["H0"][0], consts["ops"][0], *args, n_sq
            )
        gs = consts["gs"]
        if gs > 1:
            # grouped generators: one expm per (step, group)
            return forward_scan_grouped(
                consts["H0"], consts["ops"], *args, gs, n_sq,
                with_propagators=want_U,
            )
        return forward_scan_pertraj(
            consts["H0"], consts["ops"], *args, n_sq,
            with_propagators=want_U,
        )
    cdt = consts["cdtype"]
    G = consts["H0"].shape[0]
    N = consts["dt"].shape[0]
    K, d = psi0.shape
    a_all = (-1j * consts["dt"]).to(cdt)
    Us = None
    if want_U:
        Us = torch.empty((N, G, d, d), dtype=cdt, device=psi0.device)
    psi = psi0.reshape(G, K // G, d)
    states = [psi0]
    C = _gradgen_chunk(cp, n_steps=N)
    for c0 in range(0, N, C):
        sl = slice(c0, c0 + C)
        Uc = _expm_steps(
            a_all[sl, None, None, None] * _generators(consts, coeffs, sl)
        )
        if want_U:
            Us[sl] = Uc
        for U_n in Uc:
            psi = psi @ U_n.transpose(-1, -2)
            states.append(psi.reshape(K, d))
    if want_U and cp.shared_generator:
        Us = Us[:, 0]
    return torch.stack(states), Us


def _running_cost(cp: CompiledProblem, consts, states, n0=0):
    """``Σ_n w_n Σ_k g_b(Ψ_k(t_n))`` (trapezoid weights ``w``) over the
    grid points ``n0..n0+C-1`` of ``states (C, K, d)``, without ``λ_b``."""
    tl = consts["tlist"]
    w = grid_weights(tl)[n0:n0 + states.shape[0]]
    gvals = running_cost_values(cp.g_b, states, cp.trajectories, tl, n0)
    return torch.sum(w[:, None] * gvals)


def _J_parts(cp: CompiledProblem, pulsevals, psi_T, gb_sum):
    """``[J_T, λ_a J_a, λ_b J_b]`` and tau values from the final states
    and ``gb_sum`` (the weighted sum of ``g_b`` over the grid, or None)."""
    tau = taus(psi_T, cp.trajectories) if cp.has_targets else None
    if cp.J_T_takes_tau:
        J_T_val = cp.J_T(psi_T, cp.trajectories, tau=tau)
    else:
        J_T_val = cp.J_T(psi_T, cp.trajectories)
    zero = torch.zeros((), dtype=J_T_val.dtype, device=J_T_val.device)
    J_a_val = zero
    if cp.J_a is not None:
        J_a_val = cp.lambda_a * cp.J_a(pulsevals, cp.tlist)
    J_b_val = zero
    if gb_sum is not None:
        J_b_val = (cp.lambda_b * gb_sum).to(J_T_val.dtype)
    return J_T_val, J_a_val, J_b_val, tau


def _chi_boundary(cp: CompiledProblem, consts, psi_T, tau):
    """``χ(T)``, including the ``λ_b (dt_NT / 2) ξ(T)`` boundary term."""
    if cp.chi_takes_tau:
        chi = cp.chi(psi_T, cp.trajectories, tau=tau)
    else:
        chi = cp.chi(psi_T, cp.trajectories)
    if cp.xi is not None:
        dt_last = float(cp.tlist[-1] - cp.tlist[-2])
        chi = chi + cp.lambda_b * 0.5 * dt_last * cp.xi(
            psi_T, cp.trajectories, consts["tlist"], cp.n_timesteps
        )
    return chi


def _xi_sources(cp: CompiledProblem, consts, psis, n0, safe_rho):
    """The co-state sources ``λ_b·w_n·ξ(Ψ(t_n))/ρ_k`` of the steps
    ``n0..n0+C-1`` at the states ``psis (C, K, d)``, zero at ``n = 0``;
    None without ``ξ``.  ``ξ_n`` depends on ``ψ(t_n)`` alone, so all of a
    window's are formed at once (``torch.func.vmap`` over the steps);
    only their sum into the chain is sequential."""
    if cp.xi is None:
        return None
    cdt = consts["cdtype"]
    tl = consts["tlist"]
    C = psis.shape[0]
    ns = torch.arange(n0, n0 + C, device=psis.device)
    xis = torch.func.vmap(
        lambda psi, n: cp.xi(psi, cp.trajectories, tl, n)
    )(psis, ns)
    w = grid_weights(tl)[n0:n0 + C]
    scale = (cp.lambda_b * w[:, None] / safe_rho[None, :]).to(cdt)
    src = scale[:, :, None] * xis.to(cdt)
    if n0 == 0:
        src[0] = 0
    return src


def _chi_trajectory(cp: CompiledProblem, Us, chi_hat, src=None):
    """Phase A over the stored propagators of a window, ``χ ← χ conj(U_ng)``
    in reverse time, with ``Us (C, d, d)`` shared or ``(C, G, d, d)`` one
    per group of ``K / G`` trajectories, plus the sources ``src`` (ξ).
    Returns ``(chis (C, K, d), χ_out)`` with ``chis[j] = χ(t_{n0+j+1})``
    (what step ``n0 + j``'s gradient consumes) and ``χ_out`` the co-state
    carried out of the window.  Without ξ in the kernels' precision: the
    χ-scan kernel; with ξ the chain is plain PyTorch step by step (as the
    reference's χ kernel is off under ξ)."""
    Ug = Us[:, None] if Us.ndim == 3 else Us
    G = Ug.shape[1]
    K, d = chi_hat.shape
    if src is None and _kernels_enabled(cp):
        if Us.ndim == 3:
            chis = chi_scan_shared(Us, chi_hat.contiguous())
        else:
            chis = chi_scan_grouped(Us, chi_hat.contiguous())
        chi_out = (chis[0].reshape(G, K // G, d) @ Ug[0].conj()).reshape(K, d)
        return chis, chi_out
    chis = torch.empty((Ug.shape[0], K, d), dtype=chi_hat.dtype,
                       device=chi_hat.device)
    return chis, chi_window_plain(Ug, chi_hat, chis, src)


def _chi_prop_scan(cp: CompiledProblem, consts, coeffs, chi_hat, amp_max,
                   pds, src=None, n0=0):
    """Phase A without stored propagators over the window of
    ``consts``/``coeffs`` starting at step ``n0`` (a Chebyshev or Krylov
    backward direction, a stream beyond its budget, or
    ``reuse_propagators=False``), plus the sources ``src`` (ξ).  Returns
    ``(chis (C, K, d), χ_out)`` as :func:`_chi_trajectory`.

    Under the backward series: the Chebyshev-scan kernel's adjoint where it
    is gated on and the window is the whole grid without ξ (as in the
    reference), else ``χ ← exp(+i dt_n H_n†) χ`` step by step.  Under
    ExpProp: the co-state chain over propagators formed again, one
    ``exp(-i H_ng dt_n)`` per step and group, applied as
    ``χ ← χ·conj(U_ng)`` (``exp(+i dt H†) ≡ U†``); in the kernels' precision
    without ξ the propagator and χ-scan kernels do it window by window,
    otherwise the plain branch below does, a chunk of steps at a time with
    each step's own norm-derived squaring count."""
    pd_bw = pds["bw"]
    N = consts["dt"].shape[0]
    K, d = chi_hat.shape
    G = consts["H0"].shape[0]
    chis = torch.empty((N, K, d), dtype=chi_hat.dtype,
                       device=chi_hat.device)
    if pd_bw is not None:
        if (_cheby_kernel_enabled(cp, pd_bw) and src is None
                and N == cp.n_timesteps):
            chis = cheby_scan(
                consts["H0"][0], consts["ops"][0],
                coeffs.to(torch.float32).contiguous(), pd_bw["tab_bw_t"],
                pd_bw["ph_bw_t"], pd_bw["shift"], pd_bw["dE"],
                chi_hat.contiguous(), adjoint=True,
            )
            return chis, None  # the whole grid: no carry is consumed
        dts = np.diff(np.asarray(cp.tlist, dtype=np.float64)).tolist()
        chi = chi_hat.reshape(G, K // G, d)
        C = _gradgen_chunk(cp, n_steps=N)
        for c1 in range(N, 0, -C):
            c0 = max(0, c1 - C)
            Hd = _generators(consts, coeffs, slice(c0, c1)).conj()
            opT = _series_operator(pd_bw, Hd.transpose(-1, -2))
            for j in range(c1 - 1, c0 - 1, -1):
                chis[j] = chi.reshape(K, d)  # χ(t_{n+1})
                n = n0 + j
                chi = _series_prop(pd_bw, opT[j - c0], chi, dts[n], n,
                                   adjoint=True)
                if src is not None:
                    chi = chi + src[j].reshape(G, K // G, d)
        return chis, chi.reshape(K, d)
    if src is None and _kernels_enabled(cp):
        return chi_scan_recompute(
            consts["H0"], consts["ops"],
            coeffs.to(torch.float32).contiguous(),
            consts["dt"].to(torch.float32).contiguous(), chi_hat.contiguous(),
            _static_squarings(cp, amp_max),
        )
    a_all = (-1j * consts["dt"]).to(consts["cdtype"])
    C = _gradgen_chunk(cp, n_steps=N)
    chi = chi_hat
    for c1 in range(N, 0, -C):
        sl = slice(max(0, c1 - C), c1)
        Uc = _expm_steps(
            a_all[sl, None, None, None] * _generators(consts, coeffs, sl)
        )
        chi = chi_window_plain(Uc, chi, chis[sl],
                               None if src is None else src[sl])
    return chis, chi


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
    each reduced to a trace-dot with ``μ_nl``; the expm base of that
    evaluation is shared by the trajectories of one generator group.

    ``psis (N_T, K, d)`` holds the states at the step starts, ``chis`` the
    matching co-states.  Returns ``tau_grads (N_T, K, L)`` (ρ-scaled).
    """
    cdt = consts["cdtype"]
    dt = consts["dt"]
    dMc = dM.to(cdt)  # (N_T, T, L) or (K, N_T, T, L)
    n_sq = _static_squarings(cp, amp_max)
    a_all = (-1j * dt).to(cdt)
    contract = "kntl,nkt->nkl" if cp.per_traj_coeffs else "ntl,nkt->nkl"
    N_T, K, d = psis.shape

    if _kernels_enabled(cp):
        args = (
            coeffs.to(torch.float32).contiguous(), dt.to(torch.float32),
            psis.contiguous(), chis.contiguous(), n_sq,
        )
        if cp.shared_generator:
            trj = frechet_trace_shared(
                consts["H0"][0], consts["ops"][0], *args
            )
        else:
            # one operator entry per group: the kernel derives the base
            # once per (step, group) and shares it across the group's
            # directions
            trj = frechet_trace_pertraj(
                consts["H0"], consts["ops"], *args,
                group_size=consts["gs"],
            )  # (N_T, K, T)
    else:
        G = consts["H0"].shape[0]
        C = _gradgen_chunk(cp, n_steps=N_T)
        out = []
        for c0 in range(0, N_T, C):
            cs = slice(c0, c0 + C)
            # rank-1 direction R[b, a] = ψ_b(t_n) conj(χ_a(t_{n+1}))
            R = torch.einsum("ckb,cka->ckba", psis[cs], chis[cs].conj())
            Af = a_all[cs, None, None, None] * _generators(
                consts, coeffs, cs
            )  # (C, G, d, d)
            _E, Lf = expm_frechet(
                Af, R.reshape(-1, G, K // G, d, d), squarings=n_sq
            )  # (C, G, gs, d, d)
            out.append(torch.einsum(
                "gtab,cgjba->cgjt", consts["ops"], Lf
            ).reshape(-1, K, consts["ops"].shape[1]))
        trj = torch.cat(out)
    # tr(Op_j G) contracted with the control-derivative table:
    # ∇τ_{nl} = ρ (-i dt_n) Σ_j (∂a_j/∂ε_l)(ε_n) tr(Op_j G_n)
    grads = a_all[:, None, None] * torch.einsum(contract, dMc, trj)
    return rho[None, :, None].to(cdt) * grads


def _backward_vectorized(cp: CompiledProblem, consts, coeffs, dM, psis,
                         chis, rho, amp_max, n_orders):
    """Time-vectorized Taylor backward pass, phase B.

    The backward loop is sequential in time only because the co-state χ
    carries across steps, and that chain is ONE cheap propagation per step
    (``chis``, from phase A).  Everything expensive, the Taylor
    χ'-recursion and the gradient dots, depends on per-step data alone and
    runs here over the WHOLE time axis: one recursion on ``(N_T, K, L, d)``
    tensors, ``n_orders`` rounds of a few large products.  The order count
    is static (from the host envelope), so nothing is read from the device
    inside the loop; the last term is checked honestly afterwards.

    One code path serves every generator layout: ``H0 (G, d, d)``,
    ``ops (G, T, d, d)`` with the K trajectories in G groups of gs (shared:
    G = 1; one generator each: gs = 1; ``per_traj_coeffs``: G = K with one
    coefficient table per trajectory).  How ``H_n†`` is applied is
    :func:`_taylor_pass_route`'s: on the card at large d, one kernel
    launch an order (:func:`_taylor_pass_by_order`).

    Returns ``(tau_grads (N_T, K, L) [ρ-scaled], taylor_ok)``.
    """
    taylor_orders["last"] = int(n_orders)
    taylor_orders["total"] += int(n_orders)
    cdt = consts["cdtype"]
    H0, ops = consts["H0"], consts["ops"]
    G, T = ops.shape[0], ops.shape[1]
    N, K, d = psis.shape
    gs, L = K // G, cp.n_controls
    per = cp.per_traj_coeffs
    # Scaled recursion (see taylor_grad_step): iterate with H†/h so the
    # iterates stay O(1); unscaled, Φ_m ~ ‖H‖^m heads for float32 overflow
    # while the coefficient underflows.
    h = max(_h_norm_bound(cp, amp_max), 1e-30)
    route = _taylor_pass_route(d, K, G, L, T, cdt, psis.device.type,
                               _kernels_enabled(cp))
    if route == "kernel":
        if not plain_forced():
            taylor_orders["kernel"] += int(n_orders)
        return _taylor_pass_by_order(cp, consts, coeffs, dM, psis, chis, rho,
                                     h, n_orders)
    co = coeffs.to(cdt)  # (N_T, T) or (K, N_T, T)
    dMc = dM.to(cdt)     # (N_T, T, L) or (K, N_T, T, L)
    inv_h = 1.0 / h
    opsd = ops.conj().transpose(-1, -2)  # (G, T, d, d)

    def mu_apply(v):
        """μ† @ v for all (n, k, l) without materializing μ:
        μ_nl† = Σ_j (∂a_j/∂ε_l)·Op_j†."""
        vg = v.reshape(N, G, gs, d)
        if d <= _ELEMENTWISE_MAX_DIM:
            u = (opsd[None, :, None] * vg[:, :, :, None, None, :]).sum(-1)
        else:
            u = torch.einsum("gtij,ngsj->ngsti", opsd, vg)
        eq = "gntl,ngsti->ngsli" if per else "ntl,ngsti->ngsli"
        return torch.einsum(eq, dMc, u).reshape(N, K, L, d)

    # Static-operator decomposition of H†@Z at large dim: instead of
    # materializing H_n (N_T·d² memory) and running N_T separate
    # (d, d)@(d, K(L+1)) products, apply the T+1 STATIC operators to the
    # whole (N_T·K·(L+1), d) block and combine with the per-(n, t)
    # coefficients.  The same numbers; chosen where the (T+1)-fold work is
    # the cheaper side: few columns and a large d.
    if route == "static":
        H0d = H0.conj().transpose(-1, -2) * inv_h
        opsd_h = opsd * inv_h
        cc = co.conj()
        eq_c = "gnt,ntgmi->ngmi" if per else "nt,ntgmi->ngmi"

        def h_apply(Z):  # H†/h @ Z without materializing H_n
            Zg = Z.reshape(N, G, -1, d)
            out = torch.einsum("gij,ngmj->ngmi", H0d, Zg)
            parts = torch.einsum("gtij,ngmj->ntgmi", opsd_h, Zg)
            return (out + torch.einsum(eq_c, cc, parts)).reshape(Z.shape)
    else:
        Hds = _generators(consts, coeffs, slice(None)).conj().transpose(
            -1, -2
        ) * inv_h  # (N_T, G, d, d)

        def h_apply(Z):  # H†/h @ Z over the stacked (k, m) axes
            Zg = Z.reshape(N, G, -1, d)
            if d <= _ELEMENTWISE_MAX_DIM:
                out = (Hds[:, :, None] * Zg[:, :, :, None, :]).sum(-1)
            else:
                out = torch.einsum("ngij,ngmj->ngmi", Hds, Zg)
            return out.reshape(Z.shape)

    cdt_n = (1j * consts["dt"] * h).to(cdt)  # = -i·(-dt_n)·h per step
    Hm = chis  # (H†/h)^{m-1} χ, m = 1
    phi = mu_apply(chis)  # (N_T, K, L, d), scaled by h^{-(m-1)}
    coeff = cdt_n  # (i dt_n h)^m / m!
    acc = coeff[:, None, None, None] * phi  # h · χ'
    for m in range(2, n_orders + 1):
        # one fused H†@[φ | H̃m] product per order: the big operand is read
        # once instead of twice
        Z = h_apply(torch.cat([phi, Hm[:, :, None, :]], dim=2))
        Hm = Z[:, :, -1, :]
        phi = mu_apply(Hm) + Z[:, :, :-1, :]
        coeff = coeff * cdt_n / m
        acc = acc + coeff[:, None, None, None] * phi
    return _taylor_pass_result(cp, acc * inv_h,
                               coeff[:, None, None, None] * phi, psis, rho,
                               h)


def _taylor_pass_route(d, K, G, L, T, dtype, device_type, kernels=True):
    """How the vectorized Taylor pass applies ``H_n†``: ``"formed"`` (the
    ``(N_T, G, d, d)`` generators materialized; small d or many columns),
    ``"static"`` (the T + 1 static operators applied to every vector, then
    combined: from ``_STATIC_H_MIN_DIM`` with ``(T + 1)·K·(L + 1) ≤ 256``)
    or, on those shapes for complex64 CUDA tensors where the kernel is
    built for ``(K / G, L, T)`` and ``kernels`` (``_kernels_enabled``:
    not under ``use_pallas=False``), ``"kernel"``: one launch of
    ``hopper_taylor.taylor_order`` an order, with ``H_n†`` formed in
    registers.  The orders of the kernel's route count in
    ``taylor_orders["kernel"]`` unless ``plain_versions()`` runs them."""
    if not (d >= _STATIC_H_MIN_DIM and (T + 1) * K * (L + 1) <= 256):
        return "formed"
    if (kernels and device_type == "cuda" and dtype == torch.complex64
            and taylor_plan(d, 1, G, K // G, L, T) is not None):
        return "kernel"
    return "static"


def _taylor_pass_by_order(cp: CompiledProblem, consts, coeffs, dM, psis,
                          chis, rho, h, n_orders):
    """The vectorized Taylor pass of :func:`_backward_vectorized` one
    order a call of ``hopper_taylor.taylor_order``, the ``Hm`` chain one
    order ahead of ``φ`` (``hopper_taylor.taylor_pass``): one kernel
    launch an order on the card, its plain version for CPU tensors.  ``h``
    is the recursion's scale.  Returns ``(tau_grads (N_T, K, L)
    [ρ-scaled], taylor_ok)``."""
    rdt = real_dtype(consts["cdtype"])
    acc, phi, _, coef = taylor_pass(
        consts["H0"], consts["ops"], coeffs.to(rdt).contiguous(),
        dM.to(rdt).contiguous(), chis, consts["dt"], h, n_orders,
        cp.per_traj_coeffs)
    last_term = coef[:, None, None, None] * phi
    return _taylor_pass_result(cp, acc * (1.0 / h), last_term, psis, rho, h)


def _taylor_pass_result(cp: CompiledProblem, chi_prime, last_term, psis,
                        rho, h):
    """``(tau_grads, taylor_ok)`` of a vectorized Taylor pass from its sum
    ``χ' (N_T, K, L, d)`` and its last term.  Converged iff the LAST term
    was already below tolerance (the static bound is chosen so that this
    holds).  The comparison uses the SAME effective tolerance that sized
    the order count, float32 floor included: a stricter check than the
    selection rule would fail by construction."""
    term_norm = torch.sqrt(
        torch.amax(torch.sum(torch.abs(last_term) ** 2, dim=-1))
    )
    taylor_ok = term_norm < _taylor_tol_effective(cp) * h
    if not cp.taylor_grad_check_convergence:
        taylor_ok = torch.ones_like(taylor_ok)

    # ∇τ_{nkl} = ρ_k ⟨χ'_{nkl} | ψ(t_n)⟩
    grads = torch.einsum("nkli,nki->nkl", chi_prime.conj(), psis)
    return rho[None, :, None].to(chi_prime.dtype) * grads, taylor_ok


def _adjoint_ops(cp: CompiledProblem, consts, coeffs, dM, sl):
    """``(H_n† (C, G, d, d), μ_n† (C, G, L, d, d))`` of the time steps
    ``sl``, one entry per operator group (linear amplitudes)."""
    cdt = consts["cdtype"]
    ops = consts["ops"]
    if cp.per_traj_coeffs:
        mu = torch.einsum("kctl,ktij->cklij", dM[:, sl].to(cdt), ops)
    else:
        mu = torch.einsum("ctl,gtij->cglij", dM[sl].to(cdt), ops)
    H = _generators(consts, coeffs, sl)
    return H.conj().transpose(-1, -2), mu.conj().transpose(-1, -2)


def _apply_bw_prop(pd_bw, Hd, chi, dt_n, n, U_n=None):
    """One backward co-state step ``χ ← exp(+i dt_n H†) χ`` for the
    ``(G, gs, d)`` block ``chi``: with the stored forward propagator
    ``U_n (G, d, d)`` its exact adjoint (one product), else by the
    backward propagator of data ``pd_bw`` applied to the adjoint generator
    ``Hd (G, d, d)``: the exponential (ExpProp, ``pd_bw`` None), the
    Chebyshev or the Krylov series."""
    if U_n is not None:
        return torch.einsum("gji,gkj->gki", U_n.conj(), chi)
    if pd_bw is not None:
        return _series_prop(pd_bw, _series_operator(pd_bw, Hd), chi, dt_n,
                            n, adjoint=True)
    U = expm((1j * dt_n) * Hd)
    return torch.einsum("gij,gkj->gki", U, chi)


def _gradgen_series_operators(pd, Hd, mud):
    """The two matrices of the augmented generator
    ``G[H†] = [[H†, μ†], [0, H†]]`` that a series step multiplies the
    extended row-vector state ``(χ'_1..χ'_L, χ)`` by, for
    ``Hd (..., d, d)``, ``mud (..., L, d, d)``: ``_series_operator`` of
    ``H†``, and the μ† block as one ``(d, (L+1)·d)`` matrix, zero in the
    last block (the row vector χ times it gives every ``(μ_l† χ)ᵀ`` at
    once), normalized like ``H†`` under Chebyshev (``2μ†/dE``)."""
    L, d = mud.shape[-3], mud.shape[-1]
    muT = torch.cat([mud, torch.zeros_like(mud[..., :1, :, :])], dim=-3)
    muT = muT.transpose(-1, -2).transpose(-3, -2).reshape(
        mud.shape[:-3] + (d, (L + 1) * d))
    if pd["kind"] == "cheby":
        muT = (2.0 / pd["dE"]) * muT
    return _series_operator(pd, Hd), muT


def _gradgen_series_step(pd, HT, muT, chi, dt_n, n):
    """One backward gradient-generator step under the Chebyshev or Krylov
    series: the extended state ``(χ'_1..χ'_L, χ)``, zeros and the co-state
    ``chi (G, gs, d)``, propagated by the augmented generator whose
    matrices ``HT (G, d, d)``, ``muT (G, d, (L+1)·d)`` are those of
    :func:`_gradgen_series_operators`.  Returns
    ``(χ' (G, gs, L, d), χ_new (G, gs, d))``."""
    Gn, gs, d = chi.shape
    L = muT.shape[-1] // d - 1
    ext0 = torch.cat([chi.new_zeros((Gn, gs, L, d)), chi[:, :, None]],
                     dim=2)  # (G, gs, L+1, d)

    def gmatvec(v):  # v (G, gs, L+1, d)
        out = (v.reshape(Gn, -1, d) @ HT).reshape(Gn, gs, -1)
        return (out + v[:, :, -1] @ muT).reshape(Gn, gs, L + 1, d)

    if pd["kind"] == "newton":
        a = 1j * dt_n
        ext = arnoldi_expmv(
            lambda vflat: (a * gmatvec(vflat.reshape(Gn, gs, L + 1, d)))
            .reshape(Gn, gs, (L + 1) * d),
            ext0.reshape(Gn, gs, (L + 1) * d), m=pd["m"],
            substeps=pd["substeps"],
        ).reshape(Gn, gs, L + 1, d)
    else:
        # the Chebyshev series in the normalized augmented operator
        ext = cheby_apply(gmatvec, ext0, pd["tab_bw_list"][n],
                          pd["ph_bw_list"][n])
    return ext[:, :, :-1], ext[:, :, -1]


def _backward_per_step(cp: CompiledProblem, consts, coeffs, dM, psis, Us,
                       chi_hat, rho, amp_max, pds, src=None, n0=0):
    """The per-step backward pass (the fallback of the vectorized ones, and
    gradgen's pass under a Chebyshev or Krylov gradient propagator) over
    the window of ``consts``/``coeffs``/``dM`` starting at step ``n0``: in
    reverse time, one step at a time, the co-state and its control
    derivatives ``χ'_l = (∂/∂ε_l exp(+i dt H†)) χ`` by the Taylor recursion
    with its own convergence check and the ``bw`` propagator for χ
    (taylor), or by the augmented generator under the ``grad`` propagator
    (gradgen: the exponential, or the extended-state Chebyshev or Krylov
    series), and ``∇τ_{knl} = ρ_k ⟨χ'_{kl}|Ψ_k(t_n)⟩``; the sources ``src``
    (ξ) are added to χ after each step.  ``psis (C, K, d)`` holds the
    window's states at the step starts, ``Us`` its stored forward
    propagators or None.  Returns ``(tau_grads (C, K, L), taylor_ok,
    χ_out)``, ``taylor_ok`` the ``all`` over the steps."""
    cdt = consts["cdtype"]
    use_taylor = cp.gradient_method == "taylor"
    G = consts["H0"].shape[0]
    N, K, d = psis.shape
    L = cp.n_controls
    dts = np.diff(np.asarray(cp.tlist, dtype=np.float64))
    h_scale = max(_h_norm_bound(cp, amp_max), 1e-30) if use_taylor else None
    pd_grad = None if use_taylor else pds["grad"]
    chi = chi_hat.reshape(G, K // G, d)
    chi_primes = torch.empty((N, K, L, d), dtype=cdt,
                             device=chi_hat.device)
    oks = []
    # the step operators a chunk of steps at a time, then step by step
    C = _gradgen_chunk(cp, n_steps=N)
    for c1 in range(N, 0, -C):
        c0 = max(0, c1 - C)
        Hd_c, mud_c = _adjoint_ops(cp, consts, coeffs, dM, slice(c0, c1))
        if pd_grad is not None:
            HT_c, muT_c = _gradgen_series_operators(pd_grad, Hd_c, mud_c)
        for j in range(c1 - 1, c0 - 1, -1):
            Hd, mud = Hd_c[j - c0], mud_c[j - c0]
            n = n0 + j  # the global step (the tables, dt)
            dt_n = float(dts[n])
            # one generator per group, broadcast over the group's co-states
            if use_taylor:
                chi_prime, ok = taylor_grad_step(
                    Hd[:, None], mud[:, None], chi, -dt_n,
                    max_order=cp.taylor_grad_max_order,
                    tolerance=cp.taylor_grad_tolerance,
                    check_convergence=cp.taylor_grad_check_convergence,
                    with_status=True, scale=h_scale,
                )
                oks.append(ok)
                U_n = None
                if Us is not None:
                    U_n = Us[j] if Us.ndim == 4 else Us[j][None]
                chi = _apply_bw_prop(pds["bw"], Hd, chi, dt_n, n, U_n)
            elif pd_grad is not None:
                chi_prime, chi = _gradgen_series_step(
                    pd_grad, HT_c[j - c0], muT_c[j - c0], chi, dt_n, n)
            else:
                chi_prime, chi = gradgen_step(Hd[:, None], mud[:, None], chi,
                                              -dt_n)
            if src is not None:
                chi = chi + src[j].reshape(G, K // G, d)
            chi_primes[j] = chi_prime.reshape(K, L, d)
    # ∇τ_{knl} = ρ_k ⟨χ'_{kl}|Ψ_k(t_n)⟩
    grads = rho[None, :, None].to(cdt) * torch.einsum(
        "nkli,nki->nkl", chi_primes.conj(), psis)
    if oks:
        taylor_ok = torch.all(torch.stack(oks))
    else:
        taylor_ok = torch.ones((), dtype=torch.bool, device=chi_hat.device)
    return grads, taylor_ok, chi.reshape(K, d)


def _backward_window(cp: CompiledProblem, consts, coeffs, dM, psis, Us,
                     chi, rho, safe_rho, amp_max, pds, n0, vec_gg,
                     n_orders):
    """The backward pass over one time window (the whole grid under full
    storage, one segment under recompute) starting at step ``n0``: the
    window's ``consts``/``coeffs``/``dM``, its states at the step starts
    ``psis (C, K, d)``, its stored propagators ``Us`` or None, and the
    co-state ``chi`` entering it from the later side.  Phase A and the
    vectorized gradgen or taylor phase B, or the per-step pass.  Returns
    ``(tau_grads (C, K, L), taylor_ok, χ_out)``."""
    src = _xi_sources(cp, consts, psis, n0, safe_rho)
    if not (vec_gg or n_orders is not None):
        return _backward_per_step(cp, consts, coeffs, dM, psis, Us, chi,
                                  rho, amp_max, pds, src, n0)
    with span("grape.costates"):
        if Us is not None:
            chis, chi_out = _chi_trajectory(cp, Us, chi, src)
        else:
            chis, chi_out = _chi_prop_scan(cp, consts, coeffs, chi, amp_max,
                                           pds, src, n0)
    if vec_gg:
        taylor_ok = torch.ones((), dtype=torch.bool, device=chi.device)
        tau_grads = _backward_vectorized_gradgen(
            cp, consts, coeffs, dM, psis, chis, rho, amp_max)
    else:
        with span("grape.taylor_pass"):
            tau_grads, taylor_ok = _backward_vectorized(
                cp, consts, coeffs, dM, psis, chis, rho, amp_max, n_orders)
    return tau_grads, taylor_ok, chi_out


def _forward_checkpoints(cp: CompiledProblem, consts, coeffs, amp_max,
                         pds):
    """The forward pass of recompute storage: segment by segment from the
    initial states, keeping only each segment's start state, with the
    running cost summed segment by segment.  Returns
    ``(checkpoints (S, K, d), psi_T, gb_sum or None)``."""
    S = cp.storage_segments
    seg = cp.n_timesteps // S
    psi = consts["psi0"]
    checkpoints = []
    gb_sum = None
    for s in range(S):
        n0 = s * seg
        cs, co, _ = _window(cp, consts, coeffs, None, n0, n0 + seg)
        checkpoints.append(psi)
        states, _ = _forward(cp, cs, co, amp_max, pds, want_U=False,
                             psi0=psi, n0=n0)
        if cp.g_b is not None:
            part = _running_cost(cp, consts, states[:-1], n0)
            gb_sum = part if gb_sum is None else gb_sum + part
        psi = states[-1]
    if cp.g_b is not None:
        gb_sum = gb_sum + _running_cost(cp, consts, psi[None], cp.n_timesteps)
    return torch.stack(checkpoints), psi, gb_sum


def _evaluate_forward(cp: CompiledProblem, consts, coeffs, amp_max, pds,
                      want_U):
    """The forward pass in either storage mode, from the coefficient table
    ``coeffs`` of the current pulse: ``(storage, checkpoints, psi_T,
    gb_sum, Us)``.  Full storage: ``storage (N_T+1, K, d)``, checkpoints
    None, ``Us`` the step propagators where ``want_U`` asks for them (a
    forward scan may emit them unasked).  Recompute: storage None,
    ``checkpoints (S, K, d)``, ``Us`` None.  ``gb_sum`` is the weighted sum
    of ``g_b`` over the grid, or None.  One entry point for ``build_fg``,
    ``build_f``, the heterogeneous builder (per partition) and Krotov's
    method."""
    with span("grape.forward"):
        if cp.storage_mode == "recompute":
            checkpoints, psi_T, gb_sum = _forward_checkpoints(
                cp, consts, coeffs, amp_max, pds)
            return None, checkpoints, psi_T, gb_sum, None
        storage, Us = _forward(cp, consts, coeffs, amp_max, pds,
                               want_U=want_U)
        gb_sum = (None if cp.g_b is None
                  else _running_cost(cp, consts, storage))
        return storage, None, storage[-1], gb_sum, Us


def _backward_plan(cp: CompiledProblem, amp_max):
    """``(vec_gg, n_orders, reuse_U)``: the backward pass an evaluation
    takes (the vectorized gradgen pass; the vectorized Taylor pass with its
    static order count where one within ``taylor_grad_max_order`` exists;
    else the per-step pass) and whether the forward pass keeps the
    propagator stream for the co-state chain (under recompute: a segment's
    propagators, for the vectorized passes)."""
    vec_gg = _vec_gradgen_enabled(cp)
    n_orders = None
    if cp.gradient_method == "taylor" and cp.vectorize_backward:
        n_orders = _vectorized_taylor_orders(cp, amp_max)
    reuse_U = _reuse_U_enabled(cp) or (vec_gg and _gg_u_bytes_ok(cp))
    if cp.storage_mode == "recompute" and (vec_gg or n_orders is not None):
        reuse_U = _seg_reuse_U(cp)
    return vec_gg, n_orders, reuse_U


def _tau_grads_pass(cp: CompiledProblem, consts, coeffs, dM, amp_max, pds,
                    storage, checkpoints, Us, chi_hat, rho, safe_rho):
    """The backward gradient pass from the forward results of
    :func:`_evaluate_forward` and the normalized boundary co-states
    ``chi_hat`` (with their norms ``rho`` and ``safe_rho``):
    ``(tau_grads (N_T, K, L), taylor_ok)``.  The pass of
    :func:`_backward_plan` over the whole grid, or under recompute segment
    by segment in reverse: each segment propagated again from its
    checkpoint (through the same forward kernels, one launch per segment,
    with its propagators while ``_seg_reuse_U`` allows), then phases A and
    B over its window.  Shared by ``build_fg`` and the heterogeneous
    builder, which runs it per partition on its rows of ``chi_hat``."""
    with span("grape.backward"):
        vec_gg, n_orders, reuse_U = _backward_plan(cp, amp_max)
        if cp.storage_mode != "recompute":
            if not reuse_U:
                Us = None  # a forward scan may emit them unasked
            tau_grads, taylor_ok, _ = _backward_window(
                cp, consts, coeffs, dM, storage[:-1], Us, chi_hat, rho,
                safe_rho, amp_max, pds, 0, vec_gg, n_orders)
            return tau_grads, taylor_ok
        S = cp.storage_segments
        seg = cp.n_timesteps // S
        tau_grads = torch.empty((cp.n_timesteps, cp.n_traj, cp.n_controls),
                                dtype=consts["cdtype"],
                                device=chi_hat.device)
        taylor_ok = torch.ones((), dtype=torch.bool, device=chi_hat.device)
        chi = chi_hat
        for s in range(S - 1, -1, -1):
            with span("grape.segment"):
                n0 = s * seg
                cs, co, dMw = _window(cp, consts, coeffs, dM, n0, n0 + seg)
                states, Us_s = _forward(cp, cs, co, amp_max, pds,
                                        want_U=reuse_U, psi0=checkpoints[s],
                                        n0=n0)
                if not reuse_U:
                    Us_s = None  # a forward scan may emit them unasked
                grads, ok, chi = _backward_window(
                    cp, cs, co, dMw, states[:-1], Us_s, chi, rho, safe_rho,
                    amp_max, pds, n0, vec_gg, n_orders)
                tau_grads[n0:n0 + seg] = grads
                taylor_ok = taylor_ok & ok
        return tau_grads, taylor_ok


def _fw_observables(cp: CompiledProblem, consts, storage):
    """Per-step observable values over the stored forward states: each of
    ``fw_prop_observables`` ``(Psi (K, d), tlist, n) -> array`` at every
    grid point (``torch.func.vmap`` over the points), as complex tensors
    ``(N_T+1, ...)``; with no observables the states themselves."""
    if not cp.fw_prop_observables:
        return (storage,)
    tl = consts["tlist"]
    ns = torch.arange(cp.n_timesteps + 1, device=storage.device)
    return tuple(
        torch.func.vmap(lambda psi, n, _o=obs: _o(psi, tl, n))(
            storage, ns).to(consts["cdtype"])
        for obs in cp.fw_prop_observables
    )


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
    compiled for.  A heterogeneous problem (``fg_hetero``) gets
    ``build_f_hetero``, a rank's block ``parallel.build_f_sharded``."""
    if hasattr(cp, "parts"):  # heterogeneous compile
        from .fg_hetero import build_f_hetero

        return build_f_hetero(cp, amp_max=amp_max, device=device)
    if cp.mesh is not None:  # one rank's block of a sharded problem
        from .parallel import build_f_sharded

        return build_f_sharded(cp, cp.mesh, amp_max=amp_max,
                               presharded=True, device=device)[0]
    device = cp.device if device is None else resolve_device(device)
    consts = _device_constants(cp, device)
    pds = _prop_data_on(_prop_data(cp, amp_max), device)

    @torch.no_grad()
    def f(pulsevals):
        pulsevals = _as_pulse(pulsevals, consts, device)
        eps = pulsevals.reshape(cp.n_controls, cp.n_timesteps)
        coeffs, _ = _coeff_tables(cp, consts, eps)
        storage, _, psi_T, gb_sum, _ = _evaluate_forward(
            cp, consts, coeffs, amp_max, pds, want_U=False)
        with span("grape.boundary"):
            J_T_val, J_a_val, J_b_val, tau = _J_parts(cp, pulsevals, psi_T,
                                                      gb_sum)
            J = J_T_val + J_a_val + J_b_val
        aux = {
            "J_parts": torch.stack([J_T_val, J_a_val, J_b_val]),
            "tau": tau if tau is not None else _zero_tau(cp, consts, device),
            "psi_T": psi_T,
        }
        if cp.fw_prop_callback is not None:
            aux["fw_observables"] = _fw_observables(cp, consts, storage)
        return J, aux

    return f


def build_fg(cp: CompiledProblem, amp_max=None, device=None):
    """Function-and-gradient evaluation.

    Returns ``fg(pulsevals_flat) -> (J, grad_flat, aux)`` (torch tensors on
    the device) with the flat l-major pulse layout
    ``[ε_11.. ε_{N_T}1, ε_12..]``.  ``aux`` has the reference's keys;
    ``tau`` and ``psi_T`` (and ``fw_observables``) are complex tensors.
    ``device=None`` means the device the problem was compiled for.  A
    heterogeneous problem (``fg_hetero``) gets ``build_fg_hetero``, a
    rank's block (``parallel.shard_problem``) ``build_fg_sharded``.

    The forward pass is :func:`_evaluate_forward` and the gradient
    :func:`_tau_grads_pass`: under ``storage_mode="recompute"`` the forward
    pass keeps one state per segment and the backward pass propagates each
    segment again from its checkpoint.
    """
    if hasattr(cp, "parts"):  # heterogeneous compile
        from .fg_hetero import build_fg_hetero

        return build_fg_hetero(cp, amp_max=amp_max, device=device)
    if cp.mesh is not None:  # one rank's block of a sharded problem
        from .parallel import build_fg_sharded

        return build_fg_sharded(cp, cp.mesh, amp_max=amp_max,
                                presharded=True, device=device)[0]
    device = cp.device if device is None else resolve_device(device)
    consts = _device_constants(cp, device)
    pds = _prop_data_on(_prop_data(cp, amp_max), device)
    cdt = consts["cdtype"]
    # keep the propagator stream for the co-state chain while it fits its
    # budget (taylor: unless reuse_propagators says otherwise)
    reuse_U = _backward_plan(cp, amp_max)[2]

    @torch.no_grad()
    def fg(pulsevals):
        pulsevals = _as_pulse(pulsevals, consts, device)
        eps = pulsevals.reshape(cp.n_controls, cp.n_timesteps)
        coeffs, dM = _coeff_tables(cp, consts, eps)
        storage, checkpoints, psi_T, gb_sum, Us = _evaluate_forward(
            cp, consts, coeffs, amp_max, pds, want_U=reuse_U)
        with span("grape.boundary"):
            J_T_val, J_a_val, J_b_val, tau = _J_parts(cp, pulsevals, psi_T,
                                                      gb_sum)
            J = J_T_val + J_a_val + J_b_val
            chi_T = _chi_boundary(cp, consts, psi_T, tau).to(cdt)
            rho, chi_ok, safe_rho, chi_hat = _normalized_costates(cp, chi_T)
        tau_grads, taylor_ok = _tau_grads_pass(
            cp, consts, coeffs, dM, amp_max, pds, storage, checkpoints, Us,
            chi_hat, rho, safe_rho)

        grad_Tb = -2.0 * torch.real(torch.sum(tau_grads, dim=1))  # (N_T, L)
        grad, grad_Tb_flat, grad_J_a_flat = _assemble_grad(cp, pulsevals,
                                                           grad_Tb)
        aux = {
            "grad_J_Tb": grad_Tb_flat,
            "grad_J_a": grad_J_a_flat,
            "J_parts": torch.stack([J_T_val, J_a_val, J_b_val]),
            "tau": tau if tau is not None else _zero_tau(cp, consts, device),
            "psi_T": psi_T,
            "chi_ok": chi_ok,
            "taylor_ok": taylor_ok,
            "chi_norms": rho,
        }
        if cp.fw_prop_callback is not None:
            aux["fw_observables"] = _fw_observables(cp, consts, storage)
        return J, grad, aux

    return fg


def _grown_calls(S, n_calls):
    """The reference's block count for ``S`` segments: ``n_calls`` grown
    until it divides ``S``.  A count above ``S`` is taken as ``S`` (one
    segment a block), where the reference's loop would never end."""
    n_calls = int(n_calls)
    if n_calls < 1:
        raise ValueError(f"n_calls must be at least 1, got {n_calls}")
    n_calls = min(n_calls, S)
    while S % n_calls != 0:
        n_calls += 1
    return n_calls


def build_fg_multicall(cp: CompiledProblem, amp_max=None, n_calls=4,
                       device=None):
    """:func:`build_fg` under the reference's contract for an evaluation
    split into ``n_calls`` device calls: it raises ``ValueError`` unless
    storage is recompute and the backward pass is segment-vectorized
    (ExpProp gradgen, or taylor with a static order count), and grows
    ``n_calls`` until it divides ``storage_segments`` (at most that many;
    the grown count is ``fg.n_calls``).  Returns ``fg(pulsevals) -> (J,
    grad, aux)``, :func:`build_fg`'s own.

    The reference splits an evaluation (one forward call, then ``n_calls``
    backward blocks with the co-state carried between them) so that no
    single execution on its TPU platform passes the platform's time limit
    (about a minute; the 1024-sample config-5 letter needs more).  A CUDA
    device has no such limit, and the blocks would run the same segments
    in the same order with no boundary between them, so the port runs one
    evaluation: J and the gradient are :func:`build_fg`'s, bit for bit,
    in the same time.
    """
    parts = cp.parts if hasattr(cp, "parts") else [cp]
    for p in parts:
        if p.storage_mode != "recompute":
            raise ValueError(
                "build_fg_multicall requires recompute storage")
        vec_gg, n_orders, _ = _backward_plan(p, amp_max)
        if not (vec_gg or n_orders is not None):
            raise ValueError(
                "build_fg_multicall requires the segment-vectorized "
                "backward (ExpProp gradgen, or taylor with static orders)"
            )
    n_calls = _grown_calls(parts[0].storage_segments, n_calls)
    fg = build_fg(cp, amp_max=amp_max, device=device)
    fg.n_calls = n_calls
    return fg


def _normalized_costates(cp, chi_T):
    """``(ρ, chi_ok, safe ρ, χ̂)``: the norms of the boundary co-states
    ``chi_T (K, d)``, whether all exceed ``chi_min_norm``, the norms with
    zeros replaced by one, and the co-states divided by them."""
    rho = torch.sqrt(torch.sum(torch.abs(chi_T) ** 2, dim=-1))  # (K,)
    chi_ok = torch.all(rho > cp.chi_min_norm)
    safe_rho = torch.where(rho > 0, rho, torch.ones_like(rho))
    return rho, chi_ok, safe_rho, chi_T / safe_rho[:, None].to(chi_T.dtype)


def _assemble_grad(cp, pulsevals, grad_Tb):
    """``(grad, grad_J_Tb, grad_J_a)`` flat in the l-major layout from the
    ``(N_T, L)`` final-time gradient ``grad_Tb``, with ``λ_a ∇J_a`` added
    where there is a pulse running cost."""
    with span("grape.assemble"):
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
        return grad, grad_Tb_flat, grad_J_a_flat
