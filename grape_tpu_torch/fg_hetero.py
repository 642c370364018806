"""Per-trajectory propagator settings through a partitioned compile.

Counterpart of ``grape_tpu/fg_hetero.py``.  Trajectories may carry their
own ``prop_method`` / ``fw_prop_method`` / ``bw_prop_method`` /
``grad_prop_method`` (``Trajectory(..., prop_method="cheby")``), so that one
ensemble mixes Chebyshev and ExpProp propagation.  One compiled problem
propagates every trajectory alike, so the trajectories are partitioned by
the (fw, bw, grad) methods they resolve to, each partition compiles into its
own :class:`~grape_tpu_torch.fg.CompiledProblem` over the GLOBAL control
list, and one evaluation runs every partition:

- the forward pass per partition (``fg._evaluate_forward``, with the
  partition's own propagators and kernels), the final states scattered back
  into the original trajectory order;
- ``J_T``, τ and χ(T) evaluated ONCE over the whole ``(K, d)`` block
  (functionals such as ``J_T_sm`` sum coherently over the trajectories and
  do not split over partitions), plus the global ``λ_b·(dt/2)·ξ(T)``;
- the backward pass per partition (``fg._tau_grads_pass``, with whatever
  vectorized pass the partition qualifies for) on its rows of the
  normalized co-states, and the ``-2·Re Σ_k`` assembly summed over the
  partitions in their order.

State running costs: ``g_b`` and ``ξ`` are evaluated per partition with the
partition's trajectory list (the rows of ``Psi`` correspond); ``ξ`` is built
by ``make_xi`` from the global list, as in the reference; J_b is the sum of
the partitions' J_b.

The partitions run one after another on the card.

A rank of a sharded problem (``parallel.build_fg_sharded``) is evaluated by
the same builders, as ONE partition (its block of rows) whose siblings live
in other processes: ``_comm`` then gathers the final states into the global
block and reduces the gradient, ``λ_b·J_b`` and the flags over the ranks.
"""

import warnings
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from . import fg as _fg
from .config import resolve_device
from .controls import discretize_on_midpoints, get_controls
from .functionals import accepts_tau, make_chi, make_grad_J_a, make_xi, taus
from .tracing import span

__all__ = [
    "HeteroCompiledProblem", "traj_prop_partition", "compile_heterogeneous",
    "build_fg_hetero", "build_f_hetero",
]

_KEYS = _fg._PROP_SETTING_KEYS


def _effective_settings(t, kwargs):
    """The normalized (fw, bw, grad) methods one trajectory resolves to: its
    own attribute, else the global keyword, each direction falling back to
    ``prop_method``; a trajectory attribute that conflicts with an explicit
    global keyword raises ``ValueError`` (the rule of
    ``fg._merge_traj_prop_settings``)."""
    tk = getattr(t, "kwargs", None) or {}
    for key in _KEYS:
        if key in tk and kwargs.get(key) is not None:
            if (_fg._normalize_prop_method(tk[key])
                    != _fg._normalize_prop_method(kwargs[key])):
                raise ValueError(
                    f"trajectory attribute {key}={tk[key]!r} conflicts "
                    f"with the global {key}={kwargs[key]!r} keyword "
                    "argument"
                )
    base = tk.get("prop_method", kwargs.get("prop_method"))
    out = []
    for key in ("fw_prop_method", "bw_prop_method", "grad_prop_method"):
        v = tk.get(key, kwargs.get(key))
        out.append(_fg._normalize_prop_method(base if v is None else v))
    return tuple(out)


def traj_prop_partition(trajectories, kwargs):
    """The trajectories partitioned by their effective propagator settings.

    None where every trajectory resolves to the same (fw, bw, grad) methods
    (the uniform case that ``compile_problem`` takes), else a list of
    ``(settings, index_array)`` in the order of the sorted settings, with
    ``settings = dict(fw_prop_method=…, bw_prop_method=…,
    grad_prop_method=…)`` and the indices in the original order."""
    eff = [_effective_settings(t, kwargs) for t in trajectories]
    if len(set(eff)) <= 1:
        return None
    groups = {}
    for i, e in enumerate(eff):
        groups.setdefault(e, []).append(i)
    return [
        (dict(fw_prop_method=e[0], bw_prop_method=e[1],
              grad_prop_method=e[2]),
         np.asarray(idx, dtype=np.int64))
        for e, idx in sorted(groups.items())
    ]


def _part_J_T_zero(Psi, trajectories):
    """The partitions' terminal functional: a placeholder, since the global
    ``J_T`` is evaluated once over the whole state block."""
    return torch.real(torch.sum(Psi)) * 0.0


def _part_chi_zero(Psi, trajectories):
    return torch.zeros_like(Psi)


@dataclass
class HeteroCompiledProblem:
    """One :class:`~grape_tpu_torch.fg.CompiledProblem` per partition of
    the propagator settings, plus the global functional data."""

    parts: list                  # CompiledProblem per partition
    part_idx: list               # (K_p,) int index arrays, original order
    trajectories: list
    controls: tuple
    tlist: Any
    guess_pulsevals: Any
    n_controls: int
    n_timesteps: int
    n_traj: int
    dim: int
    J_T: Callable
    chi: Callable
    J_a: Callable = None
    grad_J_a: Callable = None
    lambda_a: float = 1.0
    xi: Callable = None
    lambda_b: float = 1.0
    chi_min_norm: float = 1e-100
    J_T_takes_tau: bool = False
    chi_takes_tau: bool = False
    has_targets: bool = False
    # refused by compile_heterogeneous; set on a rank's view of a sharded
    # problem (parallel.mesh._rank_view)
    fw_prop_callback: Callable = None
    taylor_grad_max_order: int = 100
    taylor_grad_tolerance: float = 1e-16
    env_cache: Any = field(default_factory=dict)
    device: Any = None

    # the workspace's view: the pulse layout is the partitions' common one
    @property
    def M(self):
        return self.parts[0].M

    @property
    def Mfix(self):
        return self.parts[0].Mfix


def compile_heterogeneous(trajectories, tlist, partition, *, J_T,
                          chi=None, J_a=None, grad_J_a=None, lambda_a=1.0,
                          g_b=None, xi=None, lambda_b=1.0,
                          chi_min_norm=1e-100, **kwargs):
    """Compile an ensemble with per-trajectory propagator settings into one
    :class:`HeteroCompiledProblem`: each partition of ``partition`` (from
    :func:`traj_prop_partition`) is ``compile_problem(sub, ...,
    _controls=<the global controls>, **settings)`` with placeholder
    functionals.  ``fw_prop_callback`` and ``mesh=`` are refused by name;
    ``use_pallas`` and ``gradgen_pallas_precision`` reach every partition's
    compile, as in the reference.
    ``device=None`` means the CUDA device and raises without one."""
    device = resolve_device(kwargs.get("device"))
    trajectories = list(trajectories)
    tlist = np.asarray(tlist, dtype=np.float64)
    controls = get_controls([t.generator for t in trajectories])
    if len(controls) == 0:
        raise ValueError("no controls in trajectories: cannot optimize")
    guess = np.stack([discretize_on_midpoints(c, tlist) for c in controls])

    if kwargs.get("fw_prop_callback") is not None:
        raise NotImplementedError(
            "fw_prop_callback is not supported with heterogeneous "
            "per-trajectory propagator settings"
        )
    if kwargs.get("mesh") is not None:
        raise NotImplementedError(
            "mesh sharding is not supported with heterogeneous "
            "per-trajectory propagator settings (partition the ensemble "
            "into uniform problems instead)"
        )

    has_targets = all(t.target_state is not None for t in trajectories)
    if chi is None:
        chi = make_chi(J_T, trajectories)
    if J_a is not None and grad_J_a is None:
        grad_J_a = make_grad_J_a(J_a, tlist)
    if lambda_b == 0 and g_b is not None:
        warnings.warn(
            "Argument `g_b` was given with `lambda_b = 0.0`. Ignoring"
        )
        g_b = None
        xi = None
    if g_b is not None and xi is None:
        xi = make_xi(g_b, trajectories)  # from the GLOBAL list

    part_kwargs = {
        k: v for k, v in kwargs.items()
        if k not in _KEYS and k not in (
            "J_T", "chi", "J_a", "grad_J_a", "lambda_a", "mesh", "device",
        )
    }
    parts = []
    part_idx = []
    for settings, idx in partition:
        sub = [trajectories[i] for i in idx]
        parts.append(_fg.compile_problem(
            sub, tlist, J_T=_part_J_T_zero, chi=_part_chi_zero,
            g_b=g_b, xi=xi, lambda_b=lambda_b, _controls=controls,
            device=device, **settings, **part_kwargs,
        ))
        part_idx.append(np.asarray(idx, dtype=np.int64))

    return HeteroCompiledProblem(
        parts=parts,
        part_idx=part_idx,
        trajectories=trajectories,
        controls=tuple(controls),
        tlist=np.asarray(tlist),
        guess_pulsevals=guess,
        n_controls=len(controls),
        n_timesteps=len(tlist) - 1,
        n_traj=len(trajectories),
        dim=parts[0].dim,
        J_T=J_T,
        chi=chi,
        J_a=J_a,
        grad_J_a=grad_J_a,
        lambda_a=float(lambda_a),
        xi=xi,
        lambda_b=float(lambda_b),
        chi_min_norm=float(chi_min_norm),
        J_T_takes_tau=accepts_tau(J_T) and has_targets,
        chi_takes_tau=accepts_tau(chi) and has_targets,
        has_targets=has_targets,
        taylor_grad_max_order=int(kwargs.get("taylor_grad_max_order", 100)),
        taylor_grad_tolerance=float(
            kwargs.get("taylor_grad_tolerance", 1e-16)),
        device=device,
    )


def _scatter_parts(hp, pieces, device):
    """The per-partition rows ``pieces`` in the original trajectory
    order."""
    out = torch.zeros((hp.n_traj,) + tuple(pieces[0].shape[1:]),
                      dtype=pieces[0].dtype, device=device)
    for idx, piece in zip(hp.part_idx, pieces):
        out[torch.as_tensor(idx, device=device)] = piece
    return out


def _part_setup(hp, amp_max, device):
    """Per partition: its device constants and propagator data (made once
    per build)."""
    consts = [_fg._device_constants(p, device) for p in hp.parts]
    pds = [_fg._prop_data_on(_fg._prop_data(p, amp_max), device)
           for p in hp.parts]
    return consts, pds


def _global_forward(hp: HeteroCompiledProblem, consts, pds, pulsevals,
                    amp_max, want_U, comm=None):
    """Every partition's forward pass, then the functional over the whole
    state block: ``(per_part, psi_T, tau, J_T, λ_a J_a, λ_b J_b)`` with
    ``per_part[p] = (coeffs, dM, storage, checkpoints, Us)``.  With
    ``comm`` (a rank's block) the block is gathered over the ranks and
    ``λ_b J_b`` is this rank's share."""
    eps = pulsevals.reshape(hp.n_controls, hp.n_timesteps)
    per_part = []
    psi_parts = []
    J_b_val = None
    for cp_p, c_p, pd_p, wu in zip(hp.parts, consts, pds, want_U):
        coeffs, dM = _fg._coeff_tables(cp_p, c_p, eps)
        storage, ckpt, psi_T_p, gb_p, Us = _fg._evaluate_forward(
            cp_p, c_p, coeffs, amp_max, pd_p, want_U=wu)
        per_part.append((coeffs, dM, storage, ckpt, Us))
        psi_parts.append(psi_T_p)
        if gb_p is not None:
            J_b_p = cp_p.lambda_b * gb_p
            J_b_val = J_b_p if J_b_val is None else J_b_val + J_b_p
    device = pulsevals.device
    psi_T = _scatter_parts(hp, psi_parts, device)
    if comm is not None:
        psi_T = comm.gather_rows(psi_T)
    tau = taus(psi_T, hp.trajectories) if hp.has_targets else None
    if hp.J_T_takes_tau:
        J_T_val = hp.J_T(psi_T, hp.trajectories, tau=tau)
    else:
        J_T_val = hp.J_T(psi_T, hp.trajectories)
    zero = torch.zeros((), dtype=J_T_val.dtype, device=J_T_val.device)
    J_a_val = zero
    if hp.J_a is not None:
        J_a_val = hp.lambda_a * hp.J_a(pulsevals, hp.tlist)
    J_b_val = zero if J_b_val is None else J_b_val.to(J_T_val.dtype)
    return per_part, psi_T, tau, J_T_val, J_a_val, J_b_val


def _global_chi_boundary(hp: HeteroCompiledProblem, tlist, psi_T, tau):
    """``χ(T)`` over all trajectories, including the
    ``λ_b (dt_NT / 2) ξ(T)`` boundary term (``fg._chi_boundary`` over the
    global trajectory list)."""
    if hp.chi_takes_tau:
        chi = hp.chi(psi_T, hp.trajectories, tau=tau)
    else:
        chi = hp.chi(psi_T, hp.trajectories)
    if hp.xi is not None:
        dt_last = float(hp.tlist[-1] - hp.tlist[-2])
        chi = chi + hp.lambda_b * 0.5 * dt_last * hp.xi(
            psi_T, hp.trajectories, tlist, hp.n_timesteps)
    return chi


def _global_observables(hp: HeteroCompiledProblem, consts, per_part, comm):
    """The per-step observables of a rank's block (the one partition of a
    sharded view) over the GLOBAL stored states, gathered over the ranks:
    every rank forms the values of the unsharded build."""
    storage = per_part[0][2]
    r0 = int(hp.part_idx[0][0])
    full = comm.gather_states(storage, (r0, r0 + storage.shape[1]),
                              hp.n_traj)
    return _fg._fw_observables(hp.parts[0], consts[0], full)


def build_fg_hetero(hp: HeteroCompiledProblem, amp_max=None, device=None,
                    _comm=None):
    """Function-and-gradient evaluation of a heterogeneous problem, with
    the contract of ``fg.build_fg`` (the same ``aux`` keys).
    ``device=None`` means the device the problem was compiled for.
    ``_comm`` (``parallel.mesh``) makes ``hp`` one rank's view of a sharded
    problem: ``J``, the gradient and the flags come out of its collectives,
    identical on every rank, and under ``fw_prop_callback`` the
    observables are formed over the gathered global states."""
    device = hp.device if device is None else resolve_device(device)
    consts, pds = _part_setup(hp, amp_max, device)
    want_U = [_fg._backward_plan(p, amp_max)[2] for p in hp.parts]
    cdt = consts[0]["cdtype"]
    rdt = consts[0]["rdtype"]
    idx_t = [torch.as_tensor(i, device=device) for i in hp.part_idx]

    @torch.no_grad()
    def fg(pulsevals):
        pulsevals = _fg._as_pulse(pulsevals, consts[0], device)
        per_part, psi_T, tau, J_T_val, J_a_val, J_b_val = _global_forward(
            hp, consts, pds, pulsevals, amp_max, want_U, _comm)

        with span("grape.boundary"):
            chi_T = _global_chi_boundary(hp, consts[0]["tlist"], psi_T,
                                         tau).to(cdt)
            rho, chi_ok, safe_rho, chi_hat = _fg._normalized_costates(
                hp, chi_T)

        grad_Tb = torch.zeros((hp.n_timesteps, hp.n_controls), dtype=rdt,
                              device=device)
        taylor_ok = torch.ones((), dtype=torch.bool, device=device)
        for cp_p, c_p, pd_p, ji, (coeffs, dM, storage, ckpt, Us) in zip(
                hp.parts, consts, pds, idx_t, per_part):
            tg_p, ok_p = _fg._tau_grads_pass(
                cp_p, c_p, coeffs, dM, amp_max, pd_p, storage, ckpt, Us,
                chi_hat[ji], rho[ji], safe_rho[ji])
            grad_Tb = grad_Tb + (
                -2.0 * torch.real(torch.sum(tg_p, dim=1))).to(rdt)
            taylor_ok = taylor_ok & ok_p
        if _comm is not None:
            (J_T_val, J_a_val, chi_bad), (J_b_val, taylor_bad), grad_Tb = (
                _comm.reduce([J_T_val, J_a_val, ~chi_ok],
                             [J_b_val, ~taylor_ok], grad_Tb))
            chi_ok, taylor_ok = ~chi_bad, ~taylor_bad
        J = J_T_val + J_a_val + J_b_val

        grad, grad_Tb_flat, grad_J_a_flat = _fg._assemble_grad(
            hp, pulsevals, grad_Tb)
        aux = {
            "grad_J_Tb": grad_Tb_flat,
            "grad_J_a": grad_J_a_flat,
            "J_parts": torch.stack([J_T_val, J_a_val, J_b_val]),
            "tau": (tau if tau is not None
                    else _fg._zero_tau(hp, consts[0], device)),
            "psi_T": psi_T,
            "chi_ok": chi_ok,
            "taylor_ok": taylor_ok,
            "chi_norms": rho,
        }
        if hp.fw_prop_callback is not None:  # a rank's block
            aux["fw_observables"] = _global_observables(hp, consts,
                                                        per_part, _comm)
        return J, grad, aux

    return fg


def build_f_hetero(hp: HeteroCompiledProblem, amp_max=None, device=None,
                   _comm=None):
    """Functional-only evaluation of a heterogeneous problem, with the
    contract of ``fg.build_f`` (``_comm`` as for :func:`build_fg_hetero`)."""
    device = hp.device if device is None else resolve_device(device)
    consts, pds = _part_setup(hp, amp_max, device)
    want_U = [False] * len(hp.parts)

    @torch.no_grad()
    def f(pulsevals):
        pulsevals = _fg._as_pulse(pulsevals, consts[0], device)
        per_part, psi_T, tau, J_T_val, J_a_val, J_b_val = _global_forward(
            hp, consts, pds, pulsevals, amp_max, want_U, _comm)
        if _comm is not None:
            (J_T_val, J_a_val), (J_b_val,), _ = _comm.reduce(
                [J_T_val, J_a_val], [J_b_val])
        J = J_T_val + J_a_val + J_b_val
        aux = {
            "J_parts": torch.stack([J_T_val, J_a_val, J_b_val]),
            "tau": (tau if tau is not None
                    else _fg._zero_tau(hp, consts[0], device)),
            "psi_T": psi_T,
        }
        if hp.fw_prop_callback is not None:  # a rank's block
            aux["fw_observables"] = _global_observables(hp, consts,
                                                        per_part, _comm)
        return J, aux

    return f
