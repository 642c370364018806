"""``grape_tpu_torch.parallel`` in one process: a gloo world of one on a
``file://`` store (the worlds of 2 and 4 are ``test_torch_distributed.py``).

The mesh builders and ``traj_axes``; ``shard_problem``'s blocks for 2 and 4
shards (the group rule of the reference's ``shard_problem``: groups cut
where they divide the shard count, expanded per trajectory where they do
not; a shared generator kept whole; ``M``/``Mfix`` rows under
``per_traj_coeffs``), the global ``norm_cache`` and coefficient envelope
that every block keeps, the "divisible" refusal; the sharded build in a
world of one equal to ``build_fg`` bit for bit; ``optimize(mesh=...)``;
``ensemble_trajectories`` against the reference's;
``max_embedded_constant_bytes`` (no effect); ``fw_prop_callback`` under
the mesh; the refusals.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import grape_tpu
import grape_tpu.parallel

import grape_tpu_torch as gt
from grape_tpu_torch import parallel
from grape_tpu_torch.fg import _coeff_env, _static_squarings
from grape_tpu_torch.functionals import J_T_sm
from grape_tpu_torch.models import (
    tls_xgate_problem, two_transmon_cz_ensemble_problem,
)
from grape_tpu_torch.parallel.mesh import _block
from grape_tpu_torch.shapes import flattop

torch.set_num_threads(1)

SZ = np.array([[1, 0], [0, -1]], dtype=complex)
SX = np.array([[0, 1], [1, 0]], dtype=complex)


@contextlib.contextmanager
def _world_of_one(path):
    parallel.init_distributed(f"file://{path}/store", 1, 0, device="cpu",
                              timeout=30)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.fixture
def world(tmp_path):
    with _world_of_one(tmp_path):
        yield


def _eps(t):
    return 0.2 * float(flattop(t, T=5, t_rise=0.3, func="blackman"))


def _tls_ensemble(K=8, shaped=False):
    """The TLS detuning ensemble; ``shaped`` gives each member its own
    amplitude shape (``per_traj_coeffs``)."""
    shared = gt.hamiltonian(-0.5 * SZ, (SX, _eps)).terms[0][1]
    trajs = []
    for k in range(K):
        amp = shared
        if shaped:
            amp = gt.ShapedAmplitude(shared, shape=lambda t, k=k: 1.0
                                     + 0.05 * k * np.sin(t))
        trajs.append(gt.Trajectory([1, 0], gt.hamiltonian(
            -0.5 * (1.0 + 0.01 * k) * SZ, (SX, amp)), target_state=[0, 1]))
    return trajs, np.linspace(0, 5, 101)


def _compile(trajs, tlist, **kw):
    return gt.compile_problem(trajs, tlist, J_T=J_T_sm, device="cpu", **kw)


def _cz_ensemble(n_samples):
    p = two_transmon_cz_ensemble_problem(n_samples=n_samples, d=2, T=4.0,
                                         n_steps=12)
    return gt.compile_problem(p.trajectories, p.tlist, device="cpu",
                              **p.kwargs)


def test_make_mesh_spans_the_world(world):
    mesh = parallel.make_mesh(device="cpu")
    assert mesh.mesh_dim_names == ("traj",) and mesh.size() == 1
    assert parallel.traj_axes(mesh) == "traj"
    assert parallel.make_mesh(1, axis="k", device="cpu").mesh_dim_names == (
        "k",)
    with pytest.raises(ValueError, match="n_devices=2.*world size is 1"):
        parallel.make_mesh(2, device="cpu")


def test_host_chip_mesh_and_traj_axes(world):
    mesh = parallel.make_host_chip_mesh(device="cpu")
    assert mesh.mesh_dim_names == ("host", "chip")
    assert tuple(mesh.mesh.shape) == (1, 1)
    assert parallel.traj_axes(mesh) == ("host", "chip")
    with pytest.raises(ValueError, match="not divisible by host count"):
        parallel.make_host_chip_mesh(n_hosts=2, device="cpu")
    cp = _compile(*_tls_ensemble(4))
    with pytest.raises(ValueError, match="must span the dimensions"):
        parallel.shard_problem(cp, mesh, axis="chip")
    block = parallel.shard_problem(cp, mesh)
    assert block.mesh_axis == ("host", "chip") and block.traj_rows == (0, 4)


def test_a_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_distributed"):
        parallel.make_mesh(device="cpu")


def test_init_distributed_picks_the_backend(tmp_path):
    """gloo for the CPU; NCCL, where asked for and missing, raises (it does
    not become gloo)."""
    if not dist.is_nccl_available():
        with pytest.raises(RuntimeError, match="nccl"):
            parallel.init_distributed(f"file://{tmp_path}/s0", 1, 0,
                                      backend="nccl", device="cpu")
        assert not dist.is_initialized()
    with _world_of_one(tmp_path):
        assert dist.get_backend() == "gloo"


# (problem, shards, expected H0 entries a block, ops_grouped after)
BLOCK_CASES = {
    "grouped_divides": (lambda: _cz_ensemble(4), 2, 2, True),
    "grouped_expanded": (lambda: _cz_ensemble(2), 4, 2, False),
    "shared_generator": (lambda: gt.compile_problem(
        *(lambda p: (p.trajectories, p.tlist))(tls_xgate_problem(
            n_steps=20)), J_T=J_T_sm, device="cpu"), 2, 1, False),
    "per_trajectory": (lambda: _compile(*_tls_ensemble(8)), 4, 2, False),
    "per_traj_coeffs": (lambda: _compile(*_tls_ensemble(8, shaped=True)),
                        2, 4, False),
}


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_block_shapes_and_group_rule(case):
    make, n, entries, grouped = BLOCK_CASES[case]
    cp = make()
    assert cp.per_traj_coeffs == (case == "per_traj_coeffs")
    assert cp.ops_grouped == case.startswith("grouped")
    K = cp.n_traj
    H0_traj = cp.H0
    if cp.ops_grouped:  # the operator of every trajectory
        H0_traj = np.repeat(cp.H0, cp.gen_group_size, axis=0)
    for pos in range(n):
        b = _block(cp, n, pos)
        r0, r1 = pos * K // n, (pos + 1) * K // n
        assert b["traj_rows"] == (r0, r1) and b["n_traj"] == K // n
        np.testing.assert_array_equal(b["psi0"], cp.psi0[r0:r1])
        assert b["trajectories"] == cp.trajectories[r0:r1]
        assert b["H0"].shape[0] == entries and b["ops_grouped"] == grouped
        assert b["ops"].shape[0] == entries
        if cp.shared_generator:
            np.testing.assert_array_equal(b["H0"], cp.H0)
        elif grouped:  # one operator row a group, none cut
            gs = cp.gen_group_size
            np.testing.assert_array_equal(
                np.repeat(b["H0"], gs, axis=0), H0_traj[r0:r1])
        else:
            np.testing.assert_array_equal(b["H0"], H0_traj[r0:r1])
        if cp.per_traj_coeffs:
            np.testing.assert_array_equal(b["M"], cp.M[r0:r1])
            np.testing.assert_array_equal(b["Mfix"], cp.Mfix[r0:r1])
        else:
            assert "M" not in b


def test_blocks_keep_the_global_norms_and_envelope():
    """Every block sizes its squarings, Taylor orders and Chebyshev degree
    from the whole ensemble: the compile-time norm cache and the
    coefficient envelope of the global tables."""
    cp = _compile(*_tls_ensemble(8, shaped=True), gradient_method="taylor")
    amp = 2.0 * np.max(np.abs(cp.guess_pulsevals), axis=1)
    for pos in range(4):
        blk = dataclasses.replace(cp, **_block(cp, 4, pos),
                                  global_problem=cp)
        assert blk.norm_cache is cp.norm_cache
        local = dataclasses.replace(cp, **_block(cp, 4, pos))
        env_g, env_b = _coeff_env(cp, amp), _coeff_env(blk, amp)
        np.testing.assert_array_equal(env_b[0], env_g[0])
        np.testing.assert_array_equal(env_b[1], env_g[1])
        assert _static_squarings(blk, amp) == _static_squarings(cp, amp)
        if pos == 0:  # the first rows alone have the smallest shapes
            local.env_cache = {}
            assert np.all(_coeff_env(local, amp)[0] < env_g[0])


def test_indivisible_ensemble_raises():
    cp = _compile(*_tls_ensemble(6))
    with pytest.raises(ValueError, match="divisible"):
        _block(cp, 4, 0)


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
@pytest.mark.parametrize("problem", ["tls8", "grouped", "per_traj_coeffs"])
def test_world_of_one_is_build_fg_bit_for_bit(world, problem, dtype):
    """The sharded build over one rank: (J, grad, aux) equal to
    ``build_fg``'s, and ``build_fg`` / ``build_f`` of a block dispatch to
    the sharded build."""
    if problem == "grouped":
        p = two_transmon_cz_ensemble_problem(n_samples=2, d=2, T=4.0,
                                             n_steps=12)
        cp = gt.compile_problem(p.trajectories, p.tlist, device="cpu",
                                dtype=dtype, **p.kwargs)
    else:
        cp = _compile(*_tls_ensemble(8, shaped=problem != "tls8"),
                      dtype=dtype)
    x = cp.guess_pulsevals.reshape(-1) * 1.1
    mesh = parallel.make_mesh(device="cpu")
    fg_s, blk = parallel.build_fg_sharded(cp, mesh)
    J, g, aux = gt.build_fg(cp)(x)
    for fn in (fg_s, gt.build_fg(blk)):
        J2, g2, aux2 = fn(x)
        assert float(J2) == float(J) and torch.equal(g2, g)
        for key in ("psi_T", "tau", "chi_norms", "grad_J_a", "J_parts"):
            assert torch.equal(aux2[key], aux[key]), key
        assert bool(aux2["taylor_ok"]) and bool(aux2["chi_ok"])
    Jf, auxf = gt.build_f(cp)(x)
    Jf2, auxf2 = gt.build_f(blk)(x)
    assert float(Jf2) == float(Jf)
    assert torch.equal(auxf2["psi_T"], auxf["psi_T"])


def test_optimize_mesh_in_a_world_of_one(world):
    """``optimize(mesh=make_mesh())`` over one rank: the workspace holds the
    block and the J_T trace is the unsharded one, bit for bit."""
    trajs, tlist = _tls_ensemble(8)
    kw = dict(J_T=J_T_sm, iter_stop=4, device="cpu", print_iters=False,
              rethrow_exceptions=True)
    traces = ([], [])
    seen = []
    mesh = parallel.make_mesh(device="cpu")

    def cb(wrk, it):
        traces[1].append(wrk.result.J_T)
        seen.append(wrk)

    gt.optimize(trajs, tlist, callback=lambda w, i: traces[0].append(
        w.result.J_T), **kw)
    gt.optimize(trajs, tlist, mesh=mesh, callback=cb, **kw)
    assert traces[0] == traces[1] and len(traces[0]) == 5
    assert seen[0].cp.mesh is mesh and seen[0].cp.traj_rows == (0, 8)
    assert seen[0].tau_vals.shape == (8,)


def test_mesh_refuses_fw_prop_callback_and_partitions(world):
    """``fw_prop_callback`` under a mesh (refused until the stored states
    were gathered over the ranks) gives the unsharded run's values, bit
    for bit, once per evaluation, with and without observables;
    per-trajectory propagator settings are refused as the reference
    refuses them."""
    trajs, tlist = _tls_ensemble(2)
    mesh = parallel.make_mesh(device="cpu")
    for observables in (None, [lambda Psi, tl, n: Psi[..., 1].abs() ** 2]):
        calls = [[], []]
        for i, m in enumerate((None, mesh)):
            gt.optimize(trajs, tlist, J_T=J_T_sm, mesh=m, device="cpu",
                        fw_prop_callback=lambda v, tl, i=i: calls[i].append(v),
                        fw_prop_observables=observables, iter_stop=2,
                        print_iters=False, rethrow_exceptions=True)
        assert len(calls[1]) == len(calls[0]) > 2
        for a, b in zip(*calls):
            assert len(a) == len(b) == 1
            assert a[0].shape == b[0].shape and np.array_equal(a[0], b[0])
    mixed = [gt.Trajectory(t.initial_state, t.generator,
                           target_state=t.target_state, prop_method=m)
             for t, m in zip(trajs, ("cheby", "expprop"))]
    hp = gt.fg_hetero.compile_heterogeneous(
        mixed, tlist, gt.fg_hetero.traj_prop_partition(mixed, {}),
        J_T=J_T_sm, device="cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        parallel.shard_problem(hp, mesh)


def test_weak_scaling_in_a_world_of_one(world):
    from grape_tpu_torch.parallel.scaling import measure_weak_scaling

    rows = measure_weak_scaling(n_devices_list=[1, 2], traj_per_device=2,
                                dim=2, n_steps=20, n_iter=1, device="cpu")
    assert len(rows) == 1 and rows[0]["n_devices"] == 1
    assert rows[0]["efficiency"] == 1.0 and rows[0]["sharded"]
    assert set(rows[0]) >= {"n_devices", "steps_per_s", "efficiency"}


def test_ensemble_trajectories_matches_reference():
    gens = [gt.hamiltonian(-0.5 * (1 + 0.01 * k) * SZ, (SX, _eps))
            for k in range(3)]
    ref_gens = [grape_tpu.hamiltonian(-0.5 * (1 + 0.01 * k) * SZ,
                                      (SX, _eps)) for k in range(3)]
    for weights in (None, [0.5, 1.0, 2.0]):
        mine = parallel.ensemble_trajectories(
            gt.Trajectory([1, 0], None, target_state=[0, 1]), gens, weights)
        ref = grape_tpu.parallel.ensemble_trajectories(
            grape_tpu.Trajectory([1, 0], None, target_state=[0, 1]),
            ref_gens, weights)
        assert len(mine) == len(ref) == 3
        for a, b, g in zip(mine, ref, gens):
            assert a.generator is g and a.weight == b.weight
            np.testing.assert_array_equal(a.initial_state, b.initial_state)
            np.testing.assert_array_equal(a.target_state, b.target_state)


def test_max_embedded_constant_bytes_has_no_effect():
    """The reference's one-device mesh for large operator arrays has no
    counterpart: a limit below the arrays' size gives the same run, and no
    process group is opened."""
    trajs, tlist = _tls_ensemble(4)
    kw = dict(J_T=J_T_sm, iter_stop=3, device="cpu", print_iters=False,
              rethrow_exceptions=True)
    plain = gt.optimize(trajs, tlist, **kw)
    tiny = gt.optimize(trajs, tlist, max_embedded_constant_bytes=1, **kw)
    assert not dist.is_initialized()
    assert tiny.J_T == plain.J_T and tiny.fg_calls == plain.fg_calls
    for a, b in zip(tiny.optimized_controls, plain.optimized_controls):
        np.testing.assert_array_equal(a, b)
