"""Trajectory parallelism over ``torch.distributed``.

Counterpart of ``grape_tpu/parallel/mesh.py``.  The reference runs one
program over a ``jax.sharding.Mesh`` (single-controller SPMD) and lets XLA
insert the ``psum`` over the sharded trajectory axis ``K``.  The port runs
one process per rank (multi-controller data parallelism, the reference's
own multi-process model of ``tests/distributed_worker.py``):

- :func:`shard_problem` cuts a compiled problem into this rank's block of
  contiguous trajectories, keeping the whole problem for what is global;
- every rank evaluates its block through the single build's phases and the
  kernels (``fg_hetero``'s builders, the rank being one partition whose
  siblings live in other processes);
- the cross-trajectory quantities go through explicit collectives: the
  final states gathered into the global ``(K, d)`` block (an all-reduce of
  a zero-filled block into which each rank writes its rows, exact since
  ``x + 0 = x``, and available on NCCL and on gloo for CUDA tensors), then
  ONE all-reduce of the gradient, ``λ_b·J_b``, the flags and the lead
  rank's ``J_T`` and ``λ_a·J_a``;
- every rank runs the outer loop in lockstep on the fully reduced
  ``(J, grad)``, which are the same bits on every rank.

Deviations from the reference: a ``DeviceMesh`` spans the whole process
group, so :func:`make_mesh` takes no device list and refuses a size other
than the world size, and the trajectory axis spans every mesh dimension.
``_put`` (the reference's complex-transfer workaround of its TPU platform)
and the device-argument builds have no counterpart: each rank moves its
arrays to its device once per build (``fg._device_constants``).
"""

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from ..config import resolve_device
from ..fg import CompiledProblem
from ..fg_hetero import HeteroCompiledProblem, build_f_hetero, build_fg_hetero
from ..trajectory import Trajectory

__all__ = [
    "make_mesh", "make_host_chip_mesh", "init_distributed", "shard_problem",
    "build_fg_sharded", "build_f_sharded", "ensemble_trajectories",
    "traj_axes",
]


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, backend=None, device=None,
                     timeout=None, **kwargs):
    """Join the process group (``torch.distributed.init_process_group``)
    and return its world size.

    ``coordinator_address`` is an init method (``"tcp://host:port"``,
    ``"file:///path"``; a bare ``"host:port"`` means TCP), None for the
    environment that ``torchrun`` sets.  ``backend=None`` is NCCL for a
    CUDA ``device`` (None: the CUDA device, raising without one) and gloo
    for the CPU; a missing NCCL raises instead of falling back to gloo.
    Two ranks that share one card must name ``backend="gloo"``, since NCCL
    refuses them.  On CUDA each rank takes the card of its local rank
    (``LOCAL_RANK``, else ``process_id``, modulo the card count).
    ``timeout`` is in seconds."""
    device = resolve_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError(
            "backend 'nccl' was asked for and this PyTorch has no NCCL; "
            "name backend='gloo' to reduce through the host"
        )
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if device.type == "cuda":
        local = os.environ.get("LOCAL_RANK", process_id)
        if local is not None:
            torch.cuda.set_device(int(local) % torch.cuda.device_count())
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=float(timeout))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=-1 if num_processes is None
                            else int(num_processes),
                            rank=-1 if process_id is None
                            else int(process_id), **kwargs)
    return dist.get_world_size()


def _world_size():
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no torch.distributed process group: call "
            "parallel.init_distributed(...) first (under torchrun: "
            "init_distributed() with no arguments)"
        )
    return dist.get_world_size()


def _init_mesh(device, shape, names):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device.type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_mesh(n_devices=None, axis="traj", device=None):
    """A 1D ``DeviceMesh`` over the trajectory axis, one rank a device.
    It spans the whole process group: ``n_devices`` other than the world
    size raises ``ValueError`` (a JAX mesh may take the first ``n``
    devices).  ``device=None`` is the CUDA device type."""
    device = resolve_device(device)
    world = _world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(
            f"make_mesh(n_devices={n_devices}): a torch DeviceMesh spans "
            f"the whole process group, whose world size is {world}"
        )
    return _init_mesh(device, (world,), (axis,))


def make_host_chip_mesh(n_hosts=None, device=None):
    """A 2D ``("host", "chip")`` mesh; the trajectory axis spans both
    (flattened host-major, so each host's blocks are contiguous).
    ``n_hosts`` defaults to the world size over ``LOCAL_WORLD_SIZE`` (the
    ranks a host that ``torchrun`` sets), else 1."""
    device = resolve_device(device)
    world = _world_size()
    if n_hosts is None:
        n_hosts = max(world // int(os.environ.get("LOCAL_WORLD_SIZE",
                                                  world)), 1)
    if world % n_hosts != 0:
        raise ValueError(
            f"device count ({world}) not divisible by host count "
            f"({n_hosts})"
        )
    return _init_mesh(device, (n_hosts, world // n_hosts), ("host", "chip"))


def traj_axes(mesh):
    """The mesh axis name (or tuple of names) the trajectory axis shards
    over: all axes of the mesh."""
    names = tuple(mesh.mesh_dim_names)
    return names[0] if len(names) == 1 else names


def _shard_count(mesh, axis):
    names = tuple(mesh.mesh_dim_names)
    axes = axis if isinstance(axis, (tuple, list)) else (axis,)
    if tuple(axes) != names:
        raise ValueError(
            f"the trajectory axis {axis!r} must span the dimensions of "
            f"the mesh {names} in order: a rank outside it would hold a "
            "copy of a block that the reduction counts twice"
        )
    return int(mesh.mesh.numel())


def _rank_position(mesh):
    """This rank's index along the flattened trajectory axis."""
    return mesh.mesh.flatten().tolist().index(dist.get_rank())


def _block(cp: CompiledProblem, n_shards, position):
    """The fields of block ``position`` of ``n_shards`` (host numpy): the
    rows of the per-trajectory arrays, the operator storage cut by group
    where the groups divide the shard count and expanded per trajectory
    first where they do not (no shard boundary may cut a group's operator
    row), a shared generator kept whole."""
    K = cp.n_traj
    if K % n_shards != 0:
        raise ValueError(
            f"number of trajectories ({K}) must be divisible by the "
            f"trajectory-axis shard count ({n_shards}); pad the ensemble "
            "with zero-weight trajectories"
        )
    Kl = K // n_shards
    r0, r1 = position * Kl, (position + 1) * Kl
    H0, ops, ops_grouped = cp.H0, cp.ops, cp.ops_grouped
    if not cp.shared_generator:
        if ops_grouped and H0.shape[0] % n_shards == 0:
            G = H0.shape[0] // n_shards
            H0 = H0[position * G:(position + 1) * G]
            ops = ops[position * G:(position + 1) * G]
        else:
            if ops_grouped:
                gs = cp.gen_group_size
                H0, ops = np.repeat(H0, gs, axis=0), np.repeat(ops, gs, axis=0)
                ops_grouped = False
            H0, ops = H0[r0:r1], ops[r0:r1]
    out = dict(
        psi0=np.ascontiguousarray(cp.psi0[r0:r1]),
        H0=np.ascontiguousarray(H0), ops=np.ascontiguousarray(ops),
        ops_grouped=ops_grouped, trajectories=list(cp.trajectories[r0:r1]),
        n_traj=Kl, traj_rows=(r0, r1),
    )
    if cp.per_traj_coeffs:
        out["M"] = np.ascontiguousarray(cp.M[r0:r1])
        out["Mfix"] = np.ascontiguousarray(cp.Mfix[r0:r1])
    return out


def shard_problem(cp: CompiledProblem, mesh, axis=None):
    """This rank's block of ``cp`` over ``mesh``: a
    :class:`~grape_tpu_torch.fg.CompiledProblem` of ``K / n`` contiguous
    trajectories (``psi0``, the operator storage, the trajectories that
    ``g_b`` and ``ξ`` see, ``M``/``Mfix`` under ``per_traj_coeffs``) that
    keeps what is global: the compile-time ``norm_cache`` (so that the
    squaring count, the Taylor order and the Chebyshev degree are the
    whole ensemble's on every rank) and the whole problem as
    ``global_problem`` (the trajectories and targets of ``J_T`` and χ(T),
    the coefficient envelope), with ``mesh``, ``mesh_axis`` and
    ``traj_rows``.  ``K`` must be divisible by the mesh size (else
    ``ValueError``, "divisible").  The kernels' route rules then see the
    local block, as the reference's per-shard gates do, and so does the
    stored-propagator budget, which binds on the rank's own card (the
    reference takes it on the global ``K``).  Under ``fw_prop_callback``
    each rank keeps its ``(N_T+1, K/n, d)`` stored states, and every
    evaluation gathers them into the global block before the observables
    are formed (:meth:`_TrajReduce.gather_states`).  A heterogeneous
    problem raises ``NotImplementedError``, as in the reference."""
    if hasattr(cp, "parts"):
        raise NotImplementedError(
            "mesh sharding is not supported with heterogeneous "
            "per-trajectory propagator settings (partition the ensemble "
            "into uniform problems instead)"
        )
    if cp.mesh is not None:
        raise ValueError("the problem is already one rank's block")
    if axis is None:
        axis = traj_axes(mesh)
    n = _shard_count(mesh, axis)
    if n != _world_size():
        raise ValueError(
            f"the mesh has {n} ranks and the process group {_world_size()}"
        )
    return dataclasses.replace(
        cp, **_block(cp, n, _rank_position(mesh)), mesh=mesh,
        mesh_axis=axis, global_problem=cp,
    )


class _TrajReduce:
    """The collectives of one sharded evaluation over the process group
    that the mesh spans; results are the same bits on every rank."""

    def __init__(self, mesh):
        self.lead = _rank_position(mesh) == 0

    def gather_rows(self, block):
        """The global ``(K, d)`` block from each rank's zero-filled copy
        holding its own rows (complex through its real view)."""
        dist.all_reduce(torch.view_as_real(block) if block.is_complex()
                        else block)
        return block

    def gather_states(self, storage, rows, n_traj):
        """The global ``(N_T+1, K, d)`` stored states from this rank's
        ``(N_T+1, K/n, d)`` block at the trajectory ``rows``: a zero-filled
        block holding this rank's rows, all-reduced as in
        :meth:`gather_rows` (exact: ``x + 0 = x``)."""
        full = storage.new_zeros((storage.shape[0], n_traj)
                                 + tuple(storage.shape[2:]))
        full[:, rows[0]:rows[1]] = storage
        return self.gather_rows(full)

    def reduce(self, lead, summed, vector=None):
        """One float64 all-reduce: the lead rank's values of ``lead``
        (J_T and λ_a·J_a, which every rank forms from the same gathered
        block, and the χ(T) flag), the sums of ``summed`` (λ_b·J_b, the
        Taylor flag) and of ``vector`` (the gradient).  Each comes back in
        its own dtype (a flag as "any rank set it")."""
        scalars = [v if self.lead else torch.zeros_like(v) for v in lead]
        scalars += summed
        parts = [torch.stack([v.to(torch.float64) for v in scalars])]
        if vector is not None:
            parts.append(vector.reshape(-1).to(torch.float64))
        buf = torch.cat(parts)
        dist.all_reduce(buf)
        out = [buf[i].to(v.dtype) for i, v in enumerate(scalars)]
        vec = None
        if vector is not None:
            vec = buf[len(scalars):].reshape(vector.shape).to(vector.dtype)
        return out[:len(lead)], out[len(lead):], vec


def _rank_view(cp: CompiledProblem):
    """This rank's block as the one partition of the global problem that
    ``fg_hetero``'s builders assemble over."""
    gp = cp.global_problem
    r0, r1 = cp.traj_rows
    return HeteroCompiledProblem(
        parts=[cp], part_idx=[np.arange(r0, r1)],
        trajectories=gp.trajectories, controls=gp.controls, tlist=gp.tlist,
        guess_pulsevals=gp.guess_pulsevals, n_controls=gp.n_controls,
        n_timesteps=gp.n_timesteps, n_traj=gp.n_traj, dim=gp.dim,
        J_T=gp.J_T, chi=gp.chi, J_a=gp.J_a, grad_J_a=gp.grad_J_a,
        lambda_a=gp.lambda_a, xi=gp.xi, lambda_b=gp.lambda_b,
        chi_min_norm=gp.chi_min_norm, J_T_takes_tau=gp.J_T_takes_tau,
        chi_takes_tau=gp.chi_takes_tau, has_targets=gp.has_targets,
        taylor_grad_max_order=gp.taylor_grad_max_order,
        taylor_grad_tolerance=gp.taylor_grad_tolerance,
        fw_prop_callback=cp.fw_prop_callback, device=cp.device,
    )


def _build_sharded(build, cp, mesh, axis, amp_max, presharded, device):
    if not presharded:
        cp = shard_problem(cp, mesh, axis=axis)
    elif cp.mesh is None:
        raise ValueError("presharded=True takes a block of shard_problem")
    fn = build(_rank_view(cp), amp_max=amp_max, device=device,
               _comm=_TrajReduce(cp.mesh))
    return fn, cp


def build_fg_sharded(cp: CompiledProblem, mesh, axis=None, amp_max=None,
                     presharded=False, device=None):
    """``(fg, block)``: the evaluation of this rank's block with the
    contract of ``fg.build_fg``, the pulse vector replicated in and
    ``(J, grad, aux)`` fully reduced out, identical on every rank (``tau``,
    ``psi_T``, ``chi_norms`` and ``fw_observables`` global).  With
    ``presharded``, ``cp`` is already a block of :func:`shard_problem`."""
    return _build_sharded(build_fg_hetero, cp, mesh, axis, amp_max,
                          presharded, device)


def build_f_sharded(cp: CompiledProblem, mesh, axis=None, amp_max=None,
                    presharded=False, device=None):
    """The sharded functional-only evaluation (line-search F probes), with
    the contract of ``fg.build_f``."""
    return _build_sharded(build_f_hetero, cp, mesh, axis, amp_max,
                          presharded, device)


def ensemble_trajectories(base_trajectory, generators, weights=None):
    """Build an ensemble (robustness-sampling) trajectory list: the same
    initial/target states evolving under perturbed generators — the
    reference's 'ensemble optimization' pattern (docs/src/tutorial.md)."""
    K = len(generators)
    if weights is None:
        weights = [1.0] * K
    return [
        Trajectory(
            base_trajectory.initial_state,
            gen,
            target_state=base_trajectory.target_state,
            weight=w,
        )
        for gen, w in zip(generators, weights)
    ]
