"""Weak-scaling measurement over the trajectory-sharded mesh.

Counterpart of ``grape_tpu/parallel/scaling.py``: the SAME sharded fg that
``optimize(mesh=...)`` runs, at a fixed trajectory count a rank, timed over
the mesh sizes the process group offers.  A ``DeviceMesh`` spans the whole
group, so a row runs for the world size; the one-device row is the
unsharded evaluation of one rank's share (no collective) where the world is
larger.  Where the ranks share one card (more ranks than cards) or reduce
through the host (gloo), a row is a test of the code path and no scaling
number: each row says so.
"""

import time

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["measure_weak_scaling"]


def _ensemble_cp(K, dim, n_steps, dtype=None, device=None):
    from ..fg import compile_problem
    from ..functionals import J_T_sm
    from ..models import transmon_ensemble_trajectories

    if dim < 3:
        # TLS detuning ensemble
        from ..generators import hamiltonian
        from ..shapes import flattop
        from ..trajectory import Trajectory

        T = 5.0

        def eps(t):
            return 0.2 * float(flattop(t, T=T, t_rise=0.3, func="blackman"))

        sz = np.array([[1, 0], [0, -1]], dtype=complex)
        sx = np.array([[0, 1], [1, 0]], dtype=complex)
        base = hamiltonian(-0.5 * sz, (sx, eps))
        shared = base.terms[0][1]
        trajs = [
            Trajectory(
                [1, 0],
                hamiltonian(-0.5 * (1 + 0.01 * k) * sz, (sx, shared)),
                target_state=[0, 1],
            )
            for k in range(K)
        ]
        tlist = np.linspace(0, T, n_steps + 1)
    else:
        trajs = transmon_ensemble_trajectories(K, d=dim, T=4.0)
        tlist = np.linspace(0, 4.0, n_steps + 1)
    return compile_problem(trajs, tlist, J_T=J_T_sm, dtype=dtype,
                           device=device)


def measure_weak_scaling(n_devices_list=(1, 2, 4, 8), traj_per_device=8,
                         dim=3, n_steps=100, n_iter=3, dtype=None,
                         device=None):
    """Time the sharded fg at ``K = traj_per_device · n_devices`` for each
    mesh size of ``n_devices_list`` that this process group runs (the
    world size, and 1); returns a list of dicts with ``steps_per_s`` and
    ``efficiency`` (relative to the first row's throughput a device), plus
    ``sharded``, ``backend`` and ``ranks_share_device``.  Every rank of the
    group must call it alike.  ``device=None`` is the CUDA device."""
    from ..config import resolve_device
    from ..fg import build_fg
    from .mesh import _world_size, build_fg_sharded, make_mesh

    device = resolve_device(device)
    world = _world_size()
    backend = dist.get_backend()
    share = device.type == "cuda" and world > torch.cuda.device_count()
    rows = []
    base_per_dev = None
    for n_dev in n_devices_list:
        if n_dev not in (1, world):
            continue
        K = traj_per_device * n_dev
        cp = _ensemble_cp(K, dim, n_steps, dtype=dtype, device=device)
        sharded = n_dev == world
        if sharded:
            fg, _ = build_fg_sharded(cp, make_mesh(device=device))
        else:
            fg = build_fg(cp)
        x = cp.guess_pulsevals.reshape(-1)
        float(fg(x)[0])  # warm-up (kernel load; scalar read = sync)
        t0 = time.perf_counter()
        for _ in range(n_iter):
            float(fg(x)[0])
        dt = (time.perf_counter() - t0) / n_iter
        steps_per_s = K * n_steps / dt
        per_dev = steps_per_s / n_dev
        if base_per_dev is None:
            base_per_dev = per_dev
        rows.append({
            "n_devices": n_dev,
            "n_traj": K,
            "steps_per_s": steps_per_s,
            "efficiency": per_dev / base_per_dev,
            "ms_per_eval": dt * 1e3,
            "sharded": sharded,
            "backend": backend if sharded else None,
            "ranks_share_device": share,
        })
    return rows
