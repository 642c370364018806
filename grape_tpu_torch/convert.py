"""State carried across from the reference: build the port's
:class:`~grape_tpu_torch.fg.CompiledProblem` (and the heterogeneous
:class:`~grape_tpu_torch.fg_hetero.HeteroCompiledProblem`) from plain numpy
arrays.

A caller that has compiled a problem elsewhere (the parity tests read the
fields off the JAX package's ``CompiledProblem``) hands the arrays over as a
dict of numpy arrays and Python scalars, so both sides compute on
bit-identical inputs.  This module imports nothing of the JAX package.
"""

import numpy as np

from . import functionals
from .config import complex_dtype, numpy_dtype, real_dtype, resolve_device
from .fg import (
    CompiledProblem, _check_fw_prop_callback, _make_norm_cache,
    _pick_segments, _prop_methods, _running_cost_closures,
)
from .functionals import accepts_tau, make_chi, make_grad_J_a
from .trajectory import Trajectory

__all__ = ["compiled_problem_from_numpy", "hetero_problem_from_numpy"]


def _functional(fn):
    """A functional given by name (``"J_T_sm"``) or as a callable."""
    if fn is None or callable(fn):
        return fn
    try:
        return getattr(functionals, str(fn))
    except AttributeError:
        raise ValueError(
            f"unknown functional {fn!r}: not in grape_tpu_torch.functionals"
        ) from None


def _trajectories(psi0, arrays):
    """Trajectories of the initial states ``psi0 (K, d)`` without a
    generator, with ``arrays``' ``target_states`` and ``weights`` where
    given: what the functionals read."""
    targets = arrays.get("target_states")
    weights = arrays.get("weights")
    out = []
    for k in range(psi0.shape[0]):
        kw = {}
        if targets is not None:
            kw["target_state"] = np.asarray(targets[k])
        if weights is not None:
            kw["weight"] = float(weights[k])
        out.append(Trajectory(psi0[k], None, **kw))
    return out


def compiled_problem_from_numpy(arrays, *, J_T, chi=None, J_a=None,
                                grad_J_a=None, lambda_a=1.0,
                                g_b=None, xi=None, lambda_b=1.0,
                                chi_min_norm=1e-100, dtype=None,
                                device=None, gradient_method="gradgen",
                                vectorize_backward=True,
                                reuse_propagators="auto",
                                taylor_grad_max_order=100,
                                taylor_grad_tolerance=1e-16,
                                taylor_grad_check_convergence=True,
                                prop_method=None, fw_prop_method=None,
                                bw_prop_method=None, grad_prop_method=None,
                                cheby_tol=1e-14, newton_m=30,
                                newton_substeps=1, storage_mode="full",
                                storage_segments=None,
                                fw_prop_callback=None,
                                fw_prop_observables=None, custom_terms=()):
    """The port's ``CompiledProblem`` from the reference's arrays.

    ``arrays`` holds ``psi0 (K, d)``, ``H0 (1 | G | K, d, d)``,
    ``ops (1 | G | K, T, d, d)`` (one entry for a shared generator, one per
    group when ``ops_grouped``, else one per trajectory), ``M (N_T, T, L)``
    and ``Mfix (N_T, T)`` (with a leading ``K`` axis when
    ``per_traj_coeffs``), ``tlist (N_T+1,)``, ``guess_pulsevals (L, N_T)``,
    ``ctl_idx`` (one entry per term, ``None`` for a locked term),
    ``shared_generator``, and optionally ``per_traj_coeffs``,
    ``gen_group_size``, ``ops_grouped``, ``norm_cache``
    (``{"h0", "ops"}`` and, where a direction is Chebyshev, ``"spec"``),
    ``target_states (K, d)`` and ``weights (K,)``.
    ``J_T`` / ``chi`` / ``J_a`` are callables of this package or their
    names (``"J_T_sm"``).  ``dtype=None`` keeps the dtype of ``psi0``.
    ``gradient_method`` (``"gradgen"`` or ``"taylor"``, as the reference's
    ``CompiledProblem`` holds it after resolving ``"auto"``),
    ``vectorize_backward``, ``reuse_propagators``, the ``taylor_grad_*``
    settings, the propagators (``prop_method`` and the per-direction
    ``fw_/bw_/grad_prop_method`` with the reference's override chain),
    ``cheby_tol`` and ``newton_m`` / ``newton_substeps`` are carried over as
    given.  Closures do not cross from the reference: the state running
    cost ``g_b`` (with ``xi``, else its ``make_xi``) and ``lambda_b``, the
    observables callback and its ``fw_prop_observables``, and the nonlinear
    amplitude slots ``custom_terms`` (``(j, CustomAmplitude, ctl_indices)``
    with this package's ``CustomAmplitude``) are given as torch functions
    of this package; ``storage_mode`` and ``storage_segments`` as for
    ``compile_problem``.
    """
    if gradient_method not in ("gradgen", "taylor"):
        raise ValueError(
            f"gradient_method must be 'gradgen' or 'taylor' here, got "
            f"{gradient_method!r}"
        )
    device = resolve_device(device)
    shared = bool(arrays.get("shared_generator", False))
    per_traj_coeffs = bool(arrays.get("per_traj_coeffs", False))
    gen_group_size = int(arrays.get("gen_group_size", 1))
    ops_grouped = bool(arrays.get("ops_grouped", False))
    psi0 = np.asarray(arrays["psi0"])
    cdtype = complex_dtype(numpy_dtype(dtype if dtype is not None
                                       else psi0.dtype))
    rdtype = real_dtype(cdtype)
    psi0 = psi0.astype(cdtype)
    K, d = psi0.shape
    H0 = np.asarray(arrays["H0"]).astype(cdtype)
    ops = np.asarray(arrays["ops"]).astype(cdtype)
    if shared:
        n_gen = 1
    elif ops_grouped:
        if gen_group_size < 1 or K % gen_group_size != 0:
            raise ValueError(
                f"gen_group_size {gen_group_size} does not divide K = {K}"
            )
        n_gen = K // gen_group_size
    else:
        n_gen = K
    if (H0.ndim != 3 or ops.ndim != 4 or H0.shape != (n_gen, d, d)
            or ops.shape[0] != n_gen or ops.shape[2:] != (d, d)):
        raise ValueError(
            f"H0 must be ({n_gen}, {d}, {d}) and ops ({n_gen}, T, {d}, {d}) "
            f"for shared_generator={shared}, ops_grouped={ops_grouped}, "
            f"gen_group_size={gen_group_size}; got {H0.shape}, {ops.shape}"
        )
    M = np.asarray(arrays["M"], dtype=rdtype)
    Mfix = np.asarray(arrays["Mfix"], dtype=rdtype)
    if M.ndim != (4 if per_traj_coeffs else 3) or Mfix.ndim != M.ndim - 1:
        raise ValueError(
            "M must be (N_T, T, L) and Mfix (N_T, T), each with a leading "
            f"K axis when per_traj_coeffs; got {M.shape}, {Mfix.shape}"
        )
    if shared and per_traj_coeffs:
        raise ValueError("a shared generator has one coefficient table")
    tlist = np.asarray(arrays["tlist"], dtype=rdtype)
    guess = np.asarray(arrays["guess_pulsevals"], dtype=np.float64)
    N_T, _, L = M.shape[-3:]

    trajectories = _trajectories(psi0, arrays)
    has_targets = arrays.get("target_states") is not None

    J_T = _functional(J_T)
    chi = _functional(chi)
    J_a = _functional(J_a)
    grad_J_a = _functional(grad_J_a)
    if chi is None:
        chi = make_chi(J_T, trajectories)
    if J_a is not None and grad_J_a is None:
        grad_J_a = make_grad_J_a(J_a, tlist)
    g_b, xi = _running_cost_closures(g_b, xi, lambda_b, trajectories)

    methods = _prop_methods(prop_method, fw_prop_method, bw_prop_method,
                            grad_prop_method)
    norm_cache = arrays.get("norm_cache")
    if norm_cache is None:
        norm_cache = _make_norm_cache(H0, ops,
                                      with_spectral="cheby" in methods)
    else:
        spec = norm_cache.get("spec")
        norm_cache = {
            "h0": float(norm_cache["h0"]),
            "ops": np.asarray(norm_cache["ops"], dtype=np.float64),
        }
        if spec is not None:
            norm_cache["spec"] = {
                key: np.asarray(spec[key], dtype=np.float64)
                for key in ("eig_lo", "eig_hi", "op2")
            }
    return CompiledProblem(
        psi0=psi0, H0=H0, ops=ops, M=M, Mfix=Mfix, tlist=tlist,
        trajectories=trajectories,
        controls=tuple(guess[l] for l in range(L)),
        guess_pulsevals=guess,
        n_controls=L, n_timesteps=N_T, dim=d, n_traj=K,
        J_T=J_T, chi=chi, J_a=J_a, grad_J_a=grad_J_a,
        lambda_a=float(lambda_a),
        g_b=g_b, xi=xi, lambda_b=float(lambda_b),
        gradient_method=gradient_method,
        taylor_grad_max_order=int(taylor_grad_max_order),
        taylor_grad_tolerance=float(taylor_grad_tolerance),
        taylor_grad_check_convergence=bool(taylor_grad_check_convergence),
        vectorize_backward=bool(vectorize_backward),
        reuse_propagators=reuse_propagators,
        chi_min_norm=float(chi_min_norm),
        J_T_takes_tau=accepts_tau(J_T) and has_targets,
        chi_takes_tau=accepts_tau(chi) and has_targets,
        has_targets=has_targets,
        prop_method=methods[0], fw_prop_method=methods[1],
        bw_prop_method=methods[2], grad_prop_method=methods[3],
        cheby_tol=float(cheby_tol), newton_m=int(newton_m),
        newton_substeps=int(newton_substeps),
        storage_mode=storage_mode,
        storage_segments=_pick_segments(storage_mode, storage_segments, N_T),
        fw_prop_callback=_check_fw_prop_callback(fw_prop_callback,
                                                 storage_mode),
        fw_prop_observables=tuple(fw_prop_observables or ()),
        custom_terms=tuple(
            (int(j), amp, tuple(int(i) for i in idxs))
            for (j, amp, idxs) in custom_terms
        ),
        ctl_idx=tuple(arrays.get("ctl_idx", ())),
        shared_generator=shared,
        per_traj_coeffs=per_traj_coeffs,
        gen_group_size=gen_group_size,
        ops_grouped=ops_grouped,
        norm_cache=norm_cache,
        device=device,
    )


_PART_SETTINGS = ("fw_prop_method", "bw_prop_method", "grad_prop_method",
                  "gradient_method")


def hetero_problem_from_numpy(fields, *, J_T, chi=None, J_a=None,
                              grad_J_a=None, lambda_a=1.0, g_b=None,
                              xi=None, lambda_b=1.0, chi_min_norm=1e-100,
                              dtype=None, device=None, **part_kwargs):
    """The port's ``HeteroCompiledProblem`` from the reference's one, field
    by field.

    ``fields`` holds ``parts``, one dict per partition in the reference's
    order: the arrays that :func:`compiled_problem_from_numpy` takes (read
    off that partition's ``CompiledProblem``) and ``settings``, its
    ``fw_prop_method``, ``bw_prop_method``, ``grad_prop_method`` and the
    resolved ``gradient_method``; ``part_idx``, the partitions' trajectory
    indices in the original order; and for the global trajectory list
    ``target_states (K, d)`` and ``weights (K,)`` where the trajectories
    have them.  Each partition goes through
    :func:`compiled_problem_from_numpy` with placeholder functionals, the
    global ``g_b`` and its ``ξ`` (``make_xi`` over the GLOBAL list where
    ``xi`` is not given, as ``compile_heterogeneous`` builds it) and
    ``part_kwargs`` (``storage_mode``, the Taylor settings, ...; the
    partition's own ``settings`` take precedence).  The
    functionals are evaluated over the global list, as in
    :func:`~grape_tpu_torch.fg_hetero.compile_heterogeneous`."""
    from .fg_hetero import (
        HeteroCompiledProblem, _part_chi_zero, _part_J_T_zero,
    )

    device = resolve_device(device)
    part_idx = [np.asarray(i, dtype=np.int64) for i in fields["part_idx"]]
    K = sum(len(i) for i in part_idx)
    first = fields["parts"][0]
    psi0 = np.zeros((K, np.asarray(first["psi0"]).shape[1]),
                    dtype=np.asarray(first["psi0"]).dtype)
    for arrays, idx in zip(fields["parts"], part_idx):
        psi0[idx] = np.asarray(arrays["psi0"])
    trajectories = _trajectories(psi0, fields)
    has_targets = fields.get("target_states") is not None
    tlist = np.asarray(first["tlist"], dtype=np.float64)

    J_T = _functional(J_T)
    chi = _functional(chi)
    J_a = _functional(J_a)
    grad_J_a = _functional(grad_J_a)
    if chi is None:
        chi = make_chi(J_T, trajectories)
    if J_a is not None and grad_J_a is None:
        grad_J_a = make_grad_J_a(J_a, tlist)
    g_b, xi = _running_cost_closures(g_b, xi, lambda_b, trajectories)

    parts = []
    for arrays in fields["parts"]:
        settings = {k: arrays["settings"][k] for k in _PART_SETTINGS
                    if k in arrays["settings"]}
        parts.append(compiled_problem_from_numpy(
            arrays, J_T=_part_J_T_zero, chi=_part_chi_zero, g_b=g_b, xi=xi,
            lambda_b=lambda_b, dtype=dtype, device=device,
            **{**part_kwargs, **settings},
        ))
    guess = np.asarray(first["guess_pulsevals"], dtype=np.float64)
    return HeteroCompiledProblem(
        parts=parts, part_idx=part_idx, trajectories=trajectories,
        controls=parts[0].controls, tlist=tlist, guess_pulsevals=guess,
        n_controls=guess.shape[0], n_timesteps=len(tlist) - 1, n_traj=K,
        dim=parts[0].dim, J_T=J_T, chi=chi, J_a=J_a, grad_J_a=grad_J_a,
        lambda_a=float(lambda_a), xi=xi, lambda_b=float(lambda_b),
        chi_min_norm=float(chi_min_norm),
        J_T_takes_tau=accepts_tau(J_T) and has_targets,
        chi_takes_tau=accepts_tau(chi) and has_targets,
        has_targets=has_targets,
        taylor_grad_max_order=int(
            part_kwargs.get("taylor_grad_max_order", 100)),
        taylor_grad_tolerance=float(
            part_kwargs.get("taylor_grad_tolerance", 1e-16)),
        device=device,
    )
