"""``grape_tpu_torch.parallel`` in real process groups: gloo worlds of 2 and
4 processes on the CPU, against ``grape_tpu``'s single-device build.

The cases of the reference's ``tests/test_parallel.py``,
``test_parallel_optimize.py``, ``test_distributed.py`` and
``test_device_loop.py::test_device_loop_sharded_matches_single_device``:

- the sharded ``fg`` (``build_fg_sharded``) against the reference's
  ``build_fg`` in complex128, J within 1e-12 and the gradient within 1e-10,
  on the TLS detuning ensemble (K = 8, also with a state running cost), the
  transmon ensemble (16 qutrits), the X-gate (a shared generator, K = 4
  over 2 ranks, with a pulse running cost), and the CZ ensemble in groups
  of 4 whose groups divide the ranks (2 groups over 2) and do not (2 over
  4: expanded per trajectory);
- ``optimize(mesh=make_mesh())``: the J_T trace the same bits on every rank
  and within 1e-12 of the reference's single-process trace (gradgen and
  taylor; the 2D ``("host", "chip")`` mesh in the world of 4); bounds with a
  pulse running cost;
- the device loop under the mesh against the plain device loop, 1e-9;
- ``measure_weak_scaling``'s rows in the world of 4;
- in the world of 2: ``fw_prop_callback``'s values (the stored states and
  an observable, from ``fg`` and ``f``) against the unsharded build, bit
  for bit; ``build_fg_multicall`` on a rank's block against
  ``build_fg_sharded``, bit for bit; the sharded evaluation of
  ``examples/03`` (``grape_tpu_torch.examples.robust_ensemble``) against
  the reference's single build, J to 1e-12 and the gradient to 1e-10.

Each world runs once per test session (a file lock in the session's shared
temporary directory, so that pytest-xdist workers wait for one run): its
processes run this module as ``python -m tests.test_torch_distributed``,
which imports nothing of JAX; the reference runs in the test process.
"""

import fcntl
import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a world's processes: seconds to rendezvous, and to finish all their work
INIT_TIMEOUT_S = 30
WORLD_TIMEOUT_S = 50
SEED = 7
FG_CASES = {2: ("tls8", "tls8_state_cost", "transmon16", "gate4",
                "grouped_divides"),
            4: ("tls8", "grouped_expanded")}
OPT_ITERS = 5
SZ = np.array([[1, 0], [0, -1]], dtype=complex)
SX = np.array([[0, 1], [1, 0]], dtype=complex)


# ---- the problems, for either package -----------------------------------

def _sub(pkg, name):
    return importlib.import_module(f"{pkg.__name__}.{name}")


def _tls8(pkg):
    """The reference's TLS detuning ensemble (``tests/test_parallel.py``)."""
    flattop = _sub(pkg, "shapes").flattop

    def eps(t):
        return 0.2 * float(flattop(t, T=5, t_rise=0.3, func="blackman"))

    shared = pkg.hamiltonian(-0.5 * SZ, (SX, eps)).terms[0][1]
    trajs = [pkg.Trajectory([1, 0], pkg.hamiltonian(
        -0.5 * (1.0 + 0.01 * k) * SZ, (SX, shared)), target_state=[0, 1])
        for k in range(8)]
    return trajs, np.linspace(0, 5, 101), {
        "J_T": _sub(pkg, "functionals").J_T_sm}


def _excited(Psi, trajectories, tlist, n):
    # builtin abs: a torch tensor in the port, a jax array in the reference
    return 1e-2 * abs(Psi[..., 1]) ** 2


def _problem(pkg, name):
    """``(trajectories, tlist, kwargs)`` of the case ``name``."""
    if name == "tls8":
        return _tls8(pkg)
    if name == "tls8_state_cost":
        trajs, tlist, kw = _tls8(pkg)
        return trajs, tlist, dict(kw, g_b=_excited, lambda_b=0.5)
    if name == "transmon16":
        trajs = _sub(pkg, "models").transmon_ensemble_trajectories(
            16, d=3, T=4.0)
        return trajs, np.linspace(0.0, 4.0, 17), {
            "J_T": _sub(pkg, "functionals").J_T_sm}
    if name == "gate4":
        p = _sub(pkg, "models").tls_xgate_problem(n_steps=100)
    else:  # the CZ ensemble in groups of 4 (ops_grouped storage)
        p = _sub(pkg, "models").two_transmon_cz_ensemble_problem(
            n_samples=2, d=2, T=4.0, n_steps=12)
    kw = {k: v for k, v in p.kwargs.items() if k not in ("iter_stop",)}
    return p.trajectories, p.tlist, kw


def _pulse(trajs, tlist, pkg):
    """The guess plus seeded noise (the same numbers in both packages)."""
    L = len(pkg.get_controls([t.generator for t in trajs]))
    guess = np.stack([pkg.discretize_on_midpoints(c, tlist)
                      for c in pkg.get_controls([t.generator
                                                 for t in trajs])])
    rng = np.random.default_rng(SEED)
    return (guess + 0.02 * rng.normal(size=(L, len(tlist) - 1))).reshape(-1)


def _opt_kwargs(pkg, method):
    trajs, tlist, kw = _tls8(pkg)
    return trajs, tlist, dict(kw, iter_stop=OPT_ITERS,
                              gradient_method=method, print_iters=False,
                              rethrow_exceptions=True)


# ---- the worker: one rank of a world -------------------------------------

def _trace(store):
    return lambda wrk, it: store.append(float(wrk.result.J_T))


def _pop1(Psi, tlist, n):
    return Psi[..., 1].abs() ** 2


def _observables_problem(gt):
    """The TLS ensemble with a ``fw_prop_callback`` (full storage)."""
    trajs, tlist, kw = _tls8(gt)
    return trajs, tlist, dict(kw, fw_prop_callback=lambda v, tl: None)


def _as_lists(values):
    return [[np.real(v).tolist(), np.imag(v).tolist()]
            for v in (x.numpy() for x in values)]


def _world2_extra(gt, parallel, mesh):
    """fw_prop_callback, build_fg_multicall and example 03 under the mesh."""
    import torch

    from grape_tpu_torch.examples import robust_ensemble
    from grape_tpu_torch.fg import build_fg_multicall

    out = {"observables": {}}
    trajs, tlist, kw = _observables_problem(gt)
    x = _pulse(trajs, tlist, gt)
    for name, obs in (("states", None), ("pop1", [_pop1])):
        cp = gt.compile_problem(trajs, tlist, device="cpu",
                                fw_prop_observables=obs, **kw)
        fg, _ = parallel.build_fg_sharded(cp, mesh)
        f, _ = parallel.build_f_sharded(cp, mesh)
        out["observables"][name] = {
            "fg": _as_lists(fg(x)[2]["fw_observables"]),
            "f": _as_lists(f(x)[1]["fw_observables"])}
    trajs, tlist, kw = _tls8(gt)
    cp = gt.compile_problem(trajs, tlist, device="cpu",
                            storage_mode="recompute", **kw)
    blk = parallel.shard_problem(cp, mesh)
    J1, g1, _ = parallel.build_fg_sharded(blk, mesh, presharded=True)[0](x)
    J2, g2, aux = build_fg_multicall(blk, n_calls=3)(x)
    out["multicall"] = {"J": float(J2), "equal": bool(
        float(J1) == float(J2) and torch.equal(g1, g2)),
        "taylor_ok": bool(aux["taylor_ok"])}
    trajs, tlist, _ = robust_ensemble.setup()
    J, g = robust_ensemble.sharded_fg(trajs, tlist, device="cpu")
    out["example03"] = {"J": J, "g": g.tolist()}
    return out


def _rank_main(rank, world, store, out_dir):
    import torch

    import grape_tpu_torch as gt
    from grape_tpu_torch import parallel
    from grape_tpu_torch.parallel.scaling import measure_weak_scaling

    torch.set_num_threads(1)
    parallel.init_distributed(f"file://{store}", world, rank, device="cpu",
                              timeout=INIT_TIMEOUT_S)
    mesh = parallel.make_mesh(device="cpu")
    out = {"rank": rank, "fg": {}, "blocks": {}}
    for name in FG_CASES[world]:
        trajs, tlist, kw = _problem(gt, name)
        cp = gt.compile_problem(trajs, tlist, device="cpu", **kw)
        fg, blk = parallel.build_fg_sharded(cp, mesh)
        J, g, aux = fg(_pulse(trajs, tlist, gt))
        out["fg"][name] = {"J": float(J), "g": g.tolist(),
                           "taylor_ok": bool(aux["taylor_ok"])}
        out["blocks"][name] = {"rows": list(blk.traj_rows),
                               "H0": list(blk.H0.shape),
                               "ops_grouped": blk.ops_grouped}
    out["opt"] = {}
    if world == 2:
        for method in ("gradgen", "taylor"):
            trajs, tlist, kw = _opt_kwargs(gt, method)
            tr = []
            gt.optimize(trajs, tlist, mesh=mesh, device="cpu",
                        callback=_trace(tr), **kw)
            out["opt"][method] = tr
        trajs, tlist, kw = _tls8(gt)
        res = gt.optimize(
            trajs, tlist, mesh=mesh, device="cpu", iter_stop=8,
            J_a=gt.functionals.J_a_fluence, lambda_a=1e-4,
            lower_bound=-0.7, upper_bound=0.7, print_iters=False,
            rethrow_exceptions=True, **kw)
        out["bounds"] = {"J_T": res.J_T, "max_amp": max(
            float(np.max(np.abs(c))) for c in res.optimized_controls)}
        dl = dict(kw, iter_stop=6, optimizer="device-lbfgs",
                  device_loop_iters=3, print_iters=False,
                  rethrow_exceptions=True, device="cpu")
        tr_mesh, tr_plain = [], []
        res_m = gt.optimize(trajs, tlist, mesh=mesh, callback=_trace(tr_mesh),
                            **dl)
        res_p = gt.optimize(trajs, tlist, callback=_trace(tr_plain), **dl)
        out["device_loop"] = {
            "mesh": tr_mesh, "plain": tr_plain,
            "controls_diff": max(float(np.max(np.abs(a - b))) for a, b in zip(
                res_m.optimized_controls, res_p.optimized_controls))}
        out.update(_world2_extra(gt, parallel, mesh))
    else:
        trajs, tlist, kw = _opt_kwargs(gt, "gradgen")
        tr = []
        gt.optimize(trajs, tlist, mesh=parallel.make_host_chip_mesh(
            n_hosts=2, device="cpu"), device="cpu", callback=_trace(tr), **kw)
        out["opt"]["host_chip"] = tr
        out["scaling"] = measure_weak_scaling(
            n_devices_list=(1, 2, 4), traj_per_device=2, dim=2, n_steps=20,
            n_iter=2, device="cpu")
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


# ---- the test side -------------------------------------------------------

def _spawn_world(world, out_dir):
    os.makedirs(out_dir, exist_ok=True)
    store = os.path.join(out_dir, "store")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.test_torch_distributed", str(r),
         str(world), store, out_dir], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORLD_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if any(p.returncode != 0 for p in procs):
        return {"error": "\n".join(
            f"rank {r} rc {p.returncode}:\n{log[-4000:]}"
            for r, (p, log) in enumerate(zip(procs, logs)))}
    ranks = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return {"ranks": ranks}


def _world_result(world, tmp_path_factory):
    """The world's output, from one run per session: the first process to
    ask runs it under the lock, the others read it."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent  # shared by the session's xdist workers
    done = root / f"torch_world{world}.json"
    with open(root / f"torch_world{world}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not done.exists():
                done.write_text(json.dumps(_spawn_world(
                    world, str(root / f"torch_world{world}"))))
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    result = json.loads(done.read_text())
    assert "error" not in result, result["error"]
    return result["ranks"]


@pytest.fixture(scope="session")
def world2(tmp_path_factory):
    return _world_result(2, tmp_path_factory)


@pytest.fixture(scope="session")
def world4(tmp_path_factory):
    return _world_result(4, tmp_path_factory)


def _reference_fg(name):
    import grape_tpu
    from grape_tpu.fg import build_fg, compile_problem

    trajs, tlist, kw = _problem(grape_tpu, name)
    cp = compile_problem(trajs, tlist, **kw)
    J, g, _ = build_fg(cp)(_pulse(trajs, tlist, grape_tpu))
    return float(J), np.asarray(g)


def _reference_trace(method):
    import grape_tpu

    trajs, tlist, kw = _opt_kwargs(grape_tpu, method)
    tr = []
    grape_tpu.optimize(trajs, tlist, callback=_trace(tr), **kw)
    return tr


@pytest.mark.parametrize("world,name", [
    (w, n) for w, names in sorted(FG_CASES.items()) for n in names])
def test_sharded_fg_matches_reference(world, name, request):
    """Every rank's reduced (J, grad) is the same bits, and within 1e-12 /
    1e-10 of the reference's single-device ``build_fg`` (complex128)."""
    ranks = request.getfixturevalue(f"world{world}")
    J_ref, g_ref = _reference_fg(name)
    first = ranks[0]["fg"][name]
    for r in ranks:
        assert r["fg"][name] == first  # J, gradient and flag: same bits
    assert first["taylor_ok"]
    assert abs(first["J"] - J_ref) < 1e-12
    assert np.max(np.abs(np.asarray(first["g"]) - g_ref)) < 1e-10


def test_shard_blocks_follow_the_group_rule(world2, world4):
    """Groups that divide the ranks are cut by group; groups that do not are
    expanded per trajectory; a shared generator is kept whole."""
    for r, rank in enumerate(world2):
        b = rank["blocks"]
        assert b["grouped_divides"] == {"rows": [4 * r, 4 * r + 4],
                                        "H0": [1, 4, 4], "ops_grouped": True}
        assert b["gate4"]["rows"] == [2 * r, 2 * r + 2]
        assert b["gate4"]["H0"] == [1, 2, 2]
        assert b["transmon16"]["rows"] == [8 * r, 8 * r + 8]
    for r, rank in enumerate(world4):
        assert rank["blocks"]["grouped_expanded"] == {
            "rows": [2 * r, 2 * r + 2], "H0": [2, 4, 4],
            "ops_grouped": False}


@pytest.mark.parametrize("method", ["gradgen", "taylor"])
def test_sharded_optimize_matches_reference(world2, method):
    """``optimize(mesh=...)``: the J_T trace is the same on both ranks, bit
    for bit, and within 1e-12 of the reference's single-process trace."""
    traces = [r["opt"][method] for r in world2]
    assert traces[0] == traces[1]
    ref = _reference_trace(method)
    assert len(traces[0]) == len(ref) == OPT_ITERS + 1
    assert np.max(np.abs(np.asarray(traces[0]) - ref)) < 1e-12
    assert traces[0][-1] < 1e-2


def test_sharded_optimize_host_chip_mesh(world4):
    """The 2D ``("host", "chip")`` mesh of 2 x 2 ranks: the same trace on
    every rank, and the reference's single-process trace to 1e-12."""
    traces = [r["opt"]["host_chip"] for r in world4]
    assert all(t == traces[0] for t in traces)
    ref = _reference_trace("gradgen")
    assert np.max(np.abs(np.asarray(traces[0]) - ref)) < 1e-12


def test_sharded_optimize_with_bounds_and_running_cost(world2):
    for r in world2:
        assert r["bounds"] == world2[0]["bounds"]
    assert world2[0]["bounds"]["J_T"] < 1e-2
    assert world2[0]["bounds"]["max_amp"] <= 0.700001


def test_device_loop_sharded_matches_plain(world2):
    """The device-resident loop under the mesh (3 iterations a chunk): the
    plain loop's J_T trace to 1e-9, the same bits on both ranks."""
    dl = world2[0]["device_loop"]
    assert world2[1]["device_loop"]["mesh"] == dl["mesh"]
    assert len(dl["mesh"]) == len(dl["plain"]) == 7
    np.testing.assert_allclose(dl["mesh"], dl["plain"], rtol=1e-9,
                               atol=1e-12)
    assert dl["controls_diff"] < 1e-9
    assert dl["mesh"][-1] < 0.5


def test_fw_prop_callback_under_the_mesh(world2):
    """The observables (and, without any, the stored states) that every
    rank hands ``fw_prop_callback`` are the unsharded build's, bit for
    bit, from ``fg`` and from ``f``."""
    import grape_tpu_torch as gt

    trajs, tlist, kw = _observables_problem(gt)
    x = _pulse(trajs, tlist, gt)
    for name, obs in (("states", None), ("pop1", [_pop1])):
        cp = gt.compile_problem(trajs, tlist, device="cpu",
                                fw_prop_observables=obs, **kw)
        want = {"fg": _as_lists(gt.build_fg(cp)(x)[2]["fw_observables"]),
                "f": _as_lists(gt.build_f(cp)(x)[1]["fw_observables"])}
        for r in world2:
            assert r["observables"][name] == want
    shape = np.asarray(world2[0]["observables"]["states"]["fg"][0][0]).shape
    assert shape == (len(tlist), 8, 2)


def test_multicall_on_a_rank_block(world2):
    """``build_fg_multicall`` on a rank's block dispatches to the sharded
    build: ``build_fg_sharded``'s J and gradient, bit for bit, and the
    reference's single build's J."""
    J_ref, _ = _reference_fg("tls8")
    for r in world2:
        assert r["multicall"]["equal"] and r["multicall"]["taylor_ok"]
        assert r["multicall"] == world2[0]["multicall"]
        assert abs(r["multicall"]["J"] - J_ref) < 1e-12


def test_example03_sharded_fg_matches_reference(world2):
    import grape_tpu.models
    from grape_tpu.fg import build_fg, compile_problem
    from grape_tpu.functionals import J_T_sm

    trajs = grape_tpu.models.transmon_ensemble_trajectories(
        16, d=3, delta_spread=0.05, T=20.0)
    cp = compile_problem(trajs, np.linspace(0, 20.0, 201), J_T=J_T_sm)
    J, g, _ = build_fg(cp)(cp.guess_pulsevals.reshape(-1))
    for r in world2:
        assert r["example03"] == world2[0]["example03"]
    assert abs(world2[0]["example03"]["J"] - float(J)) < 1e-12
    assert np.max(np.abs(np.asarray(world2[0]["example03"]["g"])
                         - np.asarray(g))) < 1e-10


def test_weak_scaling_rows(world4):
    """Rows for the mesh sizes the world runs: 1 (one rank's share, no
    collective) and 4 (sharded over gloo)."""
    rows = world4[0]["scaling"]
    assert [r["n_devices"] for r in rows] == [1, 4]
    assert [r["n_traj"] for r in rows] == [2, 8]
    assert rows[0]["efficiency"] == 1.0 and not rows[0]["sharded"]
    assert rows[1]["sharded"] and rows[1]["backend"] == "gloo"
    assert all(r["steps_per_s"] > 0 for r in rows)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
