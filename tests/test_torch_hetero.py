"""Per-trajectory propagator settings in ``grape_tpu_torch`` against
``grape_tpu``.

The merge rule of ``compile_problem`` (a uniform trajectory attribute is
adopted, a heterogeneous one refused, a conflict with the global keyword a
``ValueError``), the partition of ``fg_hetero.traj_prop_partition`` over a
table of attribute combinations, and the heterogeneous evaluation: the
reference compiles each problem with ``compile_heterogeneous``, its
partitions are carried across field by field by
``convert.hetero_problem_from_numpy``, and both sides evaluate the same
pulse.  Complex128: J to 1e-12, the gradient to 1e-10 of its max, and
``psi_T``, ``tau``, ``chi_norms`` and ``J_parts`` alike.  Last the mixed
two-level system through ``optimize``, whose J_T series must equal the
reference's to 1e-10."""

import numpy as np
import pytest
import torch

import grape_tpu
from grape_tpu.fg import build_f as ref_build_f
from grape_tpu.fg import build_fg as ref_build_fg
from grape_tpu.fg_hetero import compile_heterogeneous as ref_compile_hetero
from grape_tpu.fg_hetero import traj_prop_partition as ref_partition
from grape_tpu.functionals import J_T_re as ref_J_T_re
from grape_tpu.functionals import J_T_sm as ref_J_T_sm

import grape_tpu_torch as gt
from grape_tpu_torch import fg_hetero
from grape_tpu_torch.convert import hetero_problem_from_numpy
from grape_tpu_torch.fg_hetero import (
    HeteroCompiledProblem, compile_heterogeneous, traj_prop_partition,
)
from grape_tpu_torch.functionals import J_T_re, J_T_sm

torch.set_num_threads(1)

SZ = np.array([[1, 0], [0, -1]], dtype=complex)
SX = np.array([[0, 1], [1, 0]], dtype=complex)


def _tls(pkg, **kw):
    """The reference test's trajectory factory: one TLS Hamiltonian object
    per call, its attributes from ``kw``."""

    def eps(t):
        return 0.2 * np.cos(t)

    return pkg.Trajectory([1, 0], pkg.hamiltonian(-0.5 * SZ, (SX, eps)),
                          target_state=[0, 1], **kw)


def _arrays_of(cp):
    """One of the reference's partitions as plain numpy arrays, scalars and
    its propagator settings."""
    return {
        "psi0": np.asarray(cp.psi0), "H0": np.asarray(cp.H0),
        "ops": np.asarray(cp.ops), "M": np.asarray(cp.M),
        "Mfix": np.asarray(cp.Mfix), "tlist": np.asarray(cp.tlist),
        "guess_pulsevals": np.asarray(cp.guess_pulsevals),
        "ctl_idx": tuple(cp.ctl_idx),
        "shared_generator": bool(cp.shared_generator),
        "per_traj_coeffs": bool(cp.per_traj_coeffs),
        "gen_group_size": int(cp.gen_group_size),
        "ops_grouped": bool(getattr(cp, "ops_grouped", False)),
        "norm_cache": cp.norm_cache,
        "target_states": np.stack(
            [np.asarray(t.target_state) for t in cp.trajectories]),
        "weights": [float(t.weight) for t in cp.trajectories],
        "settings": {k: getattr(cp, k) for k in (
            "fw_prop_method", "bw_prop_method", "grad_prop_method",
            "gradient_method")},
    }


def _fields_of(hp):
    return {
        "parts": [_arrays_of(p) for p in hp.parts],
        "part_idx": [np.asarray(i) for i in hp.part_idx],
        "target_states": np.stack(
            [np.asarray(t.target_state) for t in hp.trajectories]),
        "weights": [float(t.weight) for t in hp.trajectories],
    }


def _pair(make, tlist, J_T_name="J_T_sm", port_kw=None, ref_kw=None,
          x=None, **kw):
    """The reference's heterogeneous problem and the port's, carried
    across; ``(hp_ref, hp_port, x)``."""
    ref_J_T = {"J_T_sm": ref_J_T_sm, "J_T_re": ref_J_T_re}[J_T_name]
    trajs = make(grape_tpu)
    part = ref_partition(trajs, {**kw, "J_T": ref_J_T})
    assert part is not None
    hp_r = ref_compile_hetero(trajs, tlist, part, J_T=ref_J_T,
                              **{**kw, **(ref_kw or {})})
    hp = hetero_problem_from_numpy(
        _fields_of(hp_r), J_T=J_T_name, device="cpu",
        **{**kw, **(port_kw or {})})
    if x is None:
        x = np.asarray(hp_r.guess_pulsevals).reshape(-1)
    return hp_r, hp, x


def _assert_fg_equal(hp_r, hp, x):
    J_r, g_r, aux_r = ref_build_fg(hp_r)(x)
    J, g, aux = gt.build_fg(hp)(x)
    g_r = np.asarray(g_r)
    assert abs(float(J) - float(J_r)) < 1e-12
    assert np.max(np.abs(g.numpy() - g_r)) < 1e-10 * np.max(np.abs(g_r))
    psi_r = np.asarray(grape_tpu.fg.unpack_complex(np.asarray(aux_r["psi_T"])))
    tau_r = np.asarray(grape_tpu.fg.unpack_complex(np.asarray(aux_r["tau"])))
    assert np.max(np.abs(aux["psi_T"].numpy() - psi_r)) < 1e-12
    assert np.max(np.abs(aux["tau"].numpy() - tau_r)) < 1e-12
    assert np.allclose(aux["chi_norms"].numpy(),
                       np.asarray(aux_r["chi_norms"]), rtol=1e-12, atol=0)
    assert np.allclose(aux["J_parts"].numpy(), np.asarray(aux_r["J_parts"]),
                       rtol=1e-12, atol=1e-15)
    assert bool(aux["taylor_ok"]) and bool(aux["chi_ok"])
    J_f, aux_f = gt.build_f(hp)(x)
    J_fr, _ = ref_build_f(hp_r)(x)
    assert abs(float(J_f) - float(J_fr)) < 1e-12
    assert abs(float(J_f) - float(J)) < 1e-14
    return J, g, aux


def test_per_trajectory_prop_settings():
    """The counterpart of the reference's test of the merge rule, case for
    case: a uniform attribute is adopted; a heterogeneous or a partial one
    that differs from the effective default raises ``NotImplementedError``
    mentioning per-trajectory settings and ``optimize``; a partial one
    equal to the effective default is adopted; a conflict with the global
    keyword raises ``ValueError``."""
    tlist = np.linspace(0, 2, 11)

    def mk(**kw):
        return _tls(gt, **kw)

    def compile_(trajs, **kw):
        return gt.compile_problem(trajs, tlist, J_T=J_T_sm, device="cpu",
                                  **kw)

    cp = compile_([mk(prop_method="cheby"), mk(prop_method="cheby")])
    assert cp.fw_prop_method == "cheby"
    with pytest.raises(NotImplementedError, match="per-trajectory"):
        compile_([mk(prop_method="cheby"), mk(prop_method="expprop")])
    with pytest.raises(NotImplementedError, match="optimize"):
        compile_([mk(fw_prop_method="cheby"), mk()])
    cp_part = compile_([mk(prop_method="expprop"), mk()])
    assert cp_part.fw_prop_method == "expprop"
    cp_part2 = compile_([mk(fw_prop_method="cheby"), mk()],
                        prop_method="cheby")
    assert cp_part2.fw_prop_method == "cheby"
    with pytest.raises(ValueError, match="conflicts with"):
        compile_([mk(prop_method="cheby"), mk(prop_method="cheby")],
                 prop_method="expprop")


PARTITION_TABLE = [
    # (attributes per trajectory, global keywords)
    ([{}, {}], {}),
    ([{"prop_method": "cheby"}, {}], {}),
    ([{"prop_method": "cheby"}, {"prop_method": "expprop"}, {}], {}),
    ([{"fw_prop_method": "cheby"}, {"bw_prop_method": "newton"},
      {"grad_prop_method": "cheby"}, {}], {}),
    ([{"prop_method": "chebyshev"}, {"prop_method": "cheby"}], {}),
    ([{"fw_prop_method": "cheby"}, {}], {"prop_method": "cheby"}),
    ([{"prop_method": "newton"}, {}, {"prop_method": "cheby"}],
     {"grad_prop_method": "expprop"}),
    ([{"bw_prop_method": "cheby"}, {}, {"bw_prop_method": "cheby"}],
     {"prop_method": "newton"}),
]


@pytest.mark.parametrize("attrs,global_kw", PARTITION_TABLE,
                         ids=[str(i) for i in range(len(PARTITION_TABLE))])
def test_traj_prop_partition_matches_reference(attrs, global_kw):
    """The partition (None where uniform), its settings, order and indices
    equal the reference's."""
    mine = traj_prop_partition([_tls(gt, **a) for a in attrs], global_kw)
    ref = ref_partition([_tls(grape_tpu, **a) for a in attrs], global_kw)
    if ref is None:
        assert mine is None
        return
    assert [s for s, _ in mine] == [s for s, _ in ref]
    assert [i.tolist() for _, i in mine] == [i.tolist() for _, i in ref]


def test_partition_conflict_raises():
    with pytest.raises(ValueError, match="conflicts with"):
        traj_prop_partition([_tls(gt, prop_method="cheby"), _tls(gt)],
                            {"prop_method": "expprop"})


def _mixed_tls(pkg):
    return [_tls(pkg, prop_method="cheby"), _tls(pkg, prop_method="expprop"),
            _tls(pkg)]


@pytest.mark.parametrize("gradient_method", ["gradgen", "taylor"])
def test_mixed_tls_fg_matches_reference(gradient_method):
    """The d = 2 problem of the reference's grouped-compile test (three
    trajectories: cheby, expprop, the default): J, gradient, psi_T, tau,
    chi_norms and J_parts against the reference; and, the reference's own
    identity, against the port's uniform all-ExpProp and all-Chebyshev
    builds (the same physics for every trajectory)."""
    tlist = np.linspace(0, 4, 41)
    hp_r, hp, x = _pair(_mixed_tls, tlist, gradient_method=gradient_method)
    assert isinstance(hp, HeteroCompiledProblem) and len(hp.parts) == 2
    assert [p.fw_prop_method for p in hp.parts] == ["cheby", "expprop"]
    J, g, _ = _assert_fg_equal(hp_r, hp, x)
    for method in ("expprop", "cheby"):
        cp_u = gt.compile_problem([_tls(gt) for _ in range(3)], tlist,
                                  J_T=J_T_sm, prop_method=method,
                                  gradient_method=gradient_method,
                                  device="cpu")
        J_u, g_u, _ = gt.build_fg(cp_u)(x)
        assert abs(float(J) - float(J_u)) < 1e-11, method
        assert float((g - g_u).abs().max()) < 1e-9 * float(g_u.abs().max())


def _random_d6(pkg):
    rng = np.random.default_rng(3)
    d = 6
    A = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    H0 = 0.2 * (A + A.conj().T)
    B = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    Hc = 0.2 * (B + B.conj().T)

    def eps(t):
        return 0.15 * np.sin(t)

    def mk(**kw):
        p0 = np.zeros(d, complex)
        p0[0] = 1
        tg = np.zeros(d, complex)
        tg[1] = 1
        return pkg.Trajectory(p0, pkg.hamiltonian(H0, (Hc, eps)),
                              target_state=tg, **kw)

    return [mk(fw_prop_method="cheby", bw_prop_method="cheby"), mk()]


@pytest.mark.parametrize("gradient_method", ["taylor", "gradgen"])
def test_d6_fw_bw_cheby_matches_reference(gradient_method):
    """The reference's second grouped-compile problem (d = 6, forward and
    backward Chebyshev against the default, ``J_T_re``) under both
    gradient methods, against the reference; the two methods agree."""
    tlist = np.linspace(0, 3, 31)
    hp_r, hp, x = _pair(_random_d6, tlist, J_T_name="J_T_re",
                        gradient_method=gradient_method)
    _, g, _ = _assert_fg_equal(hp_r, hp, x)
    other = {"taylor": "gradgen", "gradgen": "taylor"}[gradient_method]
    hp_o = compile_heterogeneous(
        _random_d6(gt), tlist,
        traj_prop_partition(_random_d6(gt), {}), J_T=J_T_re,
        gradient_method=other, device="cpu")
    _, g_o, _ = gt.build_fg(hp_o)(x)
    assert float((g - g_o).abs().max()) < 1e-9 * float(g.abs().max())


def test_recompute_partition_with_running_cost():
    """One partition under ``storage_mode="recompute"``, both with a state
    running cost ``g_b``: the global ξ(T) boundary, the per-partition ξ
    sources (ξ from ``make_xi`` over the global list) and J_b summed over
    the partitions, against the reference."""
    import jax.numpy as jnp

    tlist = np.linspace(0, 2, 21)

    def g_b_ref(Psi, trajectories, tlist, n):
        return 1e-2 * jnp.abs(Psi[..., 1]) ** 2

    def g_b(Psi, trajectories, tlist, n):
        return 1e-2 * torch.abs(Psi[..., 1]) ** 2

    hp_r, hp, x = _pair(
        _mixed_tls, tlist, gradient_method="taylor",
        storage_mode="recompute", storage_segments=4,
        ref_kw={"g_b": g_b_ref}, port_kw={"g_b": g_b})
    assert all(p.storage_mode == "recompute" for p in hp.parts)
    assert hp.xi is not None and hp.parts[0].xi is hp.xi
    J, grad, aux = _assert_fg_equal(hp_r, hp, x)
    assert float(aux["J_parts"][2]) > 0
    # full storage gives the same evaluation
    hp_full = compile_heterogeneous(
        _mixed_tls(gt), tlist, traj_prop_partition(_mixed_tls(gt), {}),
        J_T=J_T_sm, g_b=g_b, gradient_method="taylor", device="cpu")
    J_f, g_f, _ = gt.build_fg(hp_full)(x)
    assert abs(float(J_f) - float(J)) < 1e-13
    assert float((g_f - grad).abs().max()) < 1e-10 * float(grad.abs().max())


def _two_hamiltonians(pkg):
    """Two different Hamiltonians with two controls (the second couples
    only to the first Hamiltonian's trajectories), one trajectory of the
    second on the Chebyshev series."""

    def eps1(t):
        return 0.2 * np.cos(t)

    def eps2(t):
        return 0.1 * np.sin(2 * t)

    H1 = pkg.hamiltonian(-0.5 * SZ, (SX, eps1), (SZ, eps2))
    H2 = pkg.hamiltonian(-0.45 * SZ, (SX, eps1))
    return [pkg.Trajectory([1, 0], H1, target_state=[0, 1]),
            pkg.Trajectory([0, 1], H1, target_state=[1, 0]),
            pkg.Trajectory([1, 0], H2, target_state=[0, 1]),
            pkg.Trajectory([1, 0], H2, target_state=[0, 1],
                           prop_method="cheby")]


def test_two_hamiltonian_ensemble_one_member_on_cheby():
    """Two Hamiltonians, the last member on cheby: the cheby partition
    does not couple to the second control (zero columns of M, zero
    gradient rows from it) and the sum over partitions equals the
    reference's."""
    tlist = np.linspace(0, 3, 31)
    hp_r, hp, x = _pair(_two_hamiltonians, tlist, gradient_method="taylor")
    assert [len(i) for i in hp.part_idx] == [1, 3]
    assert hp.n_controls == 2
    assert not np.any(hp.parts[0].M[..., 1])
    _assert_fg_equal(hp_r, hp, x)
    # the port's own compile from the trajectories equals the carried one
    trajs = _two_hamiltonians(gt)
    hp_own = compile_heterogeneous(trajs, tlist,
                                   traj_prop_partition(trajs, {}),
                                   J_T=J_T_sm, gradient_method="taylor",
                                   device="cpu")
    J1, g1, _ = gt.build_fg(hp_own)(x)
    J2, g2, _ = gt.build_fg(hp)(x)
    assert abs(float(J1) - float(J2)) < 1e-14
    assert float((g1 - g2).abs().max()) < 1e-13


def test_hetero_problem_from_numpy_round_trip():
    """The port's ``compile_heterogeneous`` read back into fields and
    carried across again: the same partitions, arrays and evaluation."""
    tlist = np.linspace(0, 4, 41)
    trajs = _mixed_tls(gt)
    hp = compile_heterogeneous(trajs, tlist, traj_prop_partition(trajs, {}),
                               J_T=J_T_sm, device="cpu")
    hp2 = hetero_problem_from_numpy(_fields_of(hp), J_T="J_T_sm",
                                    device="cpu")
    for a, b in zip(hp.parts, hp2.parts):
        for key in ("psi0", "H0", "ops", "M", "Mfix", "tlist"):
            assert np.array_equal(getattr(a, key), getattr(b, key)), key
        assert (a.fw_prop_method, a.gradient_method) == (
            b.fw_prop_method, b.gradient_method)
    assert [i.tolist() for i in hp2.part_idx] == [[0], [1, 2]]
    x = hp.guess_pulsevals.reshape(-1)
    J1, g1, _ = gt.build_fg(hp)(x)
    J2, g2, _ = gt.build_fg(hp2)(x)
    assert float(J1) == float(J2) and torch.equal(g1, g2)


def test_mixed_tls_optimize_series_matches_reference():
    """The mixed TLS through ``optimize`` (the workspace partitions it):
    five L-BFGS-B iterations, the J_T series equal to the reference's to
    1e-10, below 1e-3 at the end (the reference test's anchor)."""
    tlist = np.linspace(0, 4, 41)
    series = {}
    for pkg, J_T in ((gt, J_T_sm), (grape_tpu, ref_J_T_sm)):
        seen = []
        extra = {"device": "cpu"} if pkg is gt else {}
        res = pkg.optimize(_mixed_tls(pkg), tlist, J_T=J_T, iter_stop=5,
                           print_iters=False, rethrow_exceptions=True,
                           callback=lambda wrk, it: seen.append(
                               (float(wrk.J_parts[0]),
                                type(wrk.cp).__name__)),
                           **extra)
        series[pkg.__name__] = seen
        assert res.J_T < 1e-3
    mine = [v for v, _ in series["grape_tpu_torch"]]
    ref = [v for v, _ in series["grape_tpu"]]
    assert len(mine) == len(ref) == 6
    assert {n for _, n in series["grape_tpu_torch"]} == {
        "HeteroCompiledProblem"}
    assert np.max(np.abs(np.asarray(mine) - np.asarray(ref))) < 1e-10


@pytest.mark.parametrize("option", ["mesh", "fw_prop_callback"])
def test_hetero_refuses_mesh_and_callback(option):
    """``mesh=`` and ``fw_prop_callback`` with a partition are refused by
    name, through ``optimize`` and ``compile_heterogeneous``."""
    tlist = np.linspace(0, 4, 41)
    value = object() if option == "mesh" else (lambda values, tlist: None)
    match = "mesh" if option == "mesh" else "fw_prop_callback"
    with pytest.raises(NotImplementedError, match=match):
        gt.optimize(_mixed_tls(gt), tlist, J_T=J_T_sm, iter_stop=1,
                    print_iters=False, rethrow_exceptions=True,
                    device="cpu", **{option: value})
    trajs = _mixed_tls(gt)
    with pytest.raises(NotImplementedError, match=match):
        compile_heterogeneous(trajs, tlist, traj_prop_partition(trajs, {}),
                              J_T=J_T_sm, device="cpu", **{option: value})


def test_uses_static_envelope_asks_the_parts():
    tlist = np.linspace(0, 4, 41)
    trajs = _mixed_tls(gt)
    hp = compile_heterogeneous(trajs, tlist, traj_prop_partition(trajs, {}),
                               J_T=J_T_sm, device="cpu")
    assert gt.fg.uses_static_envelope(hp)  # the cheby partition's tables
    assert fg_hetero._part_J_T_zero(torch.ones(2, 2), None) == 0


@pytest.mark.parametrize("G,gs", [(1, 2), (2, 3)])
def test_chi_chain_by_apply_scan_equals_the_chi_chain(G, gs):
    """Where the one-block scans are forced past the one-block χ scan's
    shared memory (d > 807: the dim-1024 cell's ExpProp partition, whose
    rule takes the grid scan, which reads U in place) the χ chain runs as
    the forward apply-scan over the adjoint propagators in reverse order:
    the index mapping, with a plain apply-scan in the kernel's place, gives
    the chain and the carried co-state of ``chi_window_plain`` exactly."""
    from grape_tpu_torch.ops import hopper_prop as hp

    assert hp.legacy_chi_fits(807) and not hp.legacy_chi_fits(808)
    assert hp.scan_route(1024, 1, 2, 132)["route"] == "grid"
    rng = np.random.default_rng(5)
    C, d = 7, 5
    K = G * gs
    U = torch.as_tensor(rng.normal(size=(C, G, d, d))
                        + 1j * rng.normal(size=(C, G, d, d)))
    x0 = torch.as_tensor(rng.normal(size=(K, d)) + 1j * rng.normal(size=(K, d)))

    def apply(V, x, states):
        psi = x.reshape(G, gs, d)
        states[0] = x
        for j in range(V.shape[0]):
            psi = psi @ V[j].transpose(-1, -2)
            states[j + 1] = psi.reshape(K, d)

    out = torch.empty((C, K, d), dtype=x0.dtype)
    carry = torch.empty_like(x0)
    hp._chi_by_apply(apply, U, x0, out, carry)
    want = torch.empty_like(out)
    want_carry = hp.chi_window_plain(U, x0, want)
    assert float((out - want).abs().max()) < 1e-13
    assert float((carry - want_carry).abs().max()) < 1e-13
