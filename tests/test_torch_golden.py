"""The remaining golden traces and the BASELINE anchors through
``grape_tpu_torch.optimize`` on the CPU (complex128): the per-iteration
J_T and J_b series of ``stirap_running_cost``, ``dummy_seeded``,
``lindblad_tls`` and ``subspace_gate`` in ``tests/golden/traces.json``
(recorded from the JAX package; read here, never written) at the band of
the reference's golden-trace tests (rtol 1e-3, atol 1e-10, the same
``iter``, ``converged`` and ``message``); the STIRAP running-cost anchor
(``P_max`` ratio < 0.1, taylor within 15% of gradgen); the README example
with its checkpoint reloaded; the X-gate's global phase; and the
subspace-gate model against the reference's.
"""

import json
import os

import numpy as np
import pytest
import torch

from grape_tpu.fg import build_fg as ref_build_fg
from grape_tpu.fg import compile_problem as ref_compile_problem
from grape_tpu.models import (
    two_transmon_subspace_gate_problem as ref_subspace_problem,
)

import grape_tpu_torch as gt
from grape_tpu_torch import (
    ControlProblem, Trajectory, build_fg, compile_problem, get_controls,
    hamiltonian, load_optimization, optimize_or_load, optimize_problem,
    propagate, substitute,
)
from grape_tpu_torch.functionals import J_T_sm, J_T_ss
from grape_tpu_torch.models import (
    dissipative_tls_problem, tls_xgate_problem,
    two_transmon_subspace_gate_problem,
)
from grape_tpu_torch.shapes import flattop
from grape_tpu_torch.testing import dummy_control_problem, stirap_problem

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "traces.json")


def _golden(name):
    with open(GOLDEN) as f:
        return json.load(f)[name]


def _subspace(m=None, **kw):
    build = two_transmon_subspace_gate_problem if m is None else m
    return build(d=3, n_basis=6, n_steps=50, T=10.0, E0=0.2, J=0.3, **kw)


GOLDEN_RUNS = {
    # name: (problem, optimize keywords), as tests/golden/record.py
    "stirap_running_cost": (
        lambda: stirap_problem(lambda_b=0.4, iter_stop=25),
        dict(gradient_method="taylor")),
    "dummy_seeded": (
        lambda: dummy_control_problem(
            N=2, rng=np.random.default_rng(1244538994), iter_stop=100),
        dict(J_T=J_T_ss, check_convergence=lambda r: (
            "J_T < 10⁻⁵" if r.J_T < 1e-5 else ""))),
    "lindblad_tls": (
        lambda: dissipative_tls_problem(gamma=0.05, n_steps=200,
                                        iter_stop=15), {}),
    "subspace_gate": (lambda: _subspace(iter_stop=15), {}),
}


@pytest.mark.parametrize("name", sorted(GOLDEN_RUNS))
def test_golden_trace(name):
    build, updates = GOLDEN_RUNS[name]
    ref = _golden(name)
    trace, trace_b = [], []

    def cb(wrk, iteration):
        trace.append(float(wrk.result.J_T))
        trace_b.append(float(wrk.result.J_b))

    res = optimize_problem(build(), callback=cb, print_iters=False,
                           rethrow_exceptions=True, device="cpu", **updates)
    assert len(trace) == len(ref["J_T_trace"])
    np.testing.assert_allclose(trace, ref["J_T_trace"], rtol=1e-3,
                               atol=1e-10)
    np.testing.assert_allclose(trace_b, ref["J_b_trace"], rtol=1e-3,
                               atol=1e-10)
    assert res.iter == ref["iter"]
    assert res.converged == ref["converged"]
    assert res.message == ref["message"]
    if name == "dummy_seeded":
        # the pinned convergence iteration of numpy's seed (the
        # reference's StableRNG seed converges at 17)
        assert res.iter == 20 and res.J_T < 1e-5
    if name == "lindblad_tls":
        assert res.J_T < 0.1  # beats the gamma = 0.05 decay
    if name == "subspace_gate":
        assert trace[-1] < 0.6 * trace[0]


class TestStirapRunningCost:
    """The reference's STIRAP anchor: the intermediate-level running cost
    suppresses its population by more than ten times, and the taylor
    gradient reaches the same ``P_max`` within 15%."""

    @pytest.fixture(scope="class")
    def setup(self):
        # the STIRAP ladder of ``testing.stirap_problem`` (the reference
        # test's own system), its g_b and the analytic ξ = -D·Ψ
        p = stirap_problem(n_steps=500)
        traj = p.trajectories[0]
        minus_middle = torch.tensor([0.0, -1.0, 0.0], dtype=torch.float64)

        def xi(Psi, trajectories, tl, n):
            return Psi * minus_middle

        return dict(H=traj.generator, tlist=p.tlist, trajectory=traj,
                    g_b=p.kwargs["g_b"], xi=xi, ket1=traj.initial_state)

    def _pmax2(self, setup, result):
        H_opt = substitute(setup["H"], list(zip(
            get_controls(setup["H"]), result.optimized_controls)))
        dyn = propagate(setup["ket1"], H_opt, setup["tlist"], storage=True,
                        device="cpu")
        return float(np.max(np.abs(dyn[:, 1]) ** 2))

    @pytest.fixture(scope="class")
    def result1(self, setup):
        return optimize_problem(ControlProblem(
            [setup["trajectory"]], setup["tlist"], J_T=J_T_ss, iter_stop=50,
            g_b=setup["g_b"], lambda_b=0.0,
            check_convergence=lambda res: (
                "J_T < 10⁻²" if res.J_T <= 1e-2 else ""),
            print_iters=False, rethrow_exceptions=True, device="cpu"))

    @pytest.fixture(scope="class")
    def problem2(self, setup):
        return ControlProblem(
            [setup["trajectory"]], setup["tlist"], J_T=J_T_ss, iter_stop=100,
            check_convergence=lambda res: (
                res.J_T <= 1e-2 and res.J_b <= 1e-2),
            g_b=setup["g_b"], xi=setup["xi"], lambda_b=4e-1,
            store_iter_info=["J", "J_T", "J_b", "λ_b⋅J_b", "ǁ∇Jǁ", "ΔJ"],
            print_iters=False, rethrow_exceptions=True, device="cpu")

    @pytest.fixture(scope="class")
    def result2(self, problem2):
        return optimize_problem(problem2, gradient_method="gradgen")

    def test_without_running_cost(self, setup, result1):
        assert result1.J_b == 0.0 and result1.J_b_prev == 0.0
        assert result1.converged
        assert self._pmax2(setup, result1) > 0.5

    def test_running_cost_suppresses_population(self, setup, result1,
                                                result2):
        assert result2.iter > result1.iter + 10
        assert result2.converged
        assert result2.message == "Convergence check returned true"
        assert result2.J_b > 0.0 and result2.J_b_prev > 0.0
        deltas = [rec[-1] for rec in result2.records][1:]
        assert max(deltas) < 0  # ΔJ < 0 after iteration 0
        assert self._pmax2(setup, result2) / self._pmax2(
            setup, result1) < 1e-1

    def test_taylor_agrees_within_15_percent(self, setup, result1, result2,
                                            problem2):
        result3 = optimize_problem(problem2, gradient_method="taylor")
        assert result3.converged
        P_taylor = self._pmax2(setup, result3)
        assert abs(P_taylor - self._pmax2(setup, result2)) / P_taylor < 0.15
        assert P_taylor / self._pmax2(setup, result1) < 1e-1


def test_readme_example_with_checkpoint(tmp_path):
    def eps(t):
        return 0.2 * float(flattop(t, T=5, t_rise=0.3, func="blackman"))

    sz = np.array([[1, 0], [0, -1]], dtype=complex)
    sx = np.array([[0, 1], [1, 0]], dtype=complex)
    H = hamiltonian(-0.5 * sz, (sx, eps))
    tlist = np.linspace(0, 5, 501)
    traj = Trajectory([1, 0], H, target_state=[0, 1])
    fn = str(tmp_path / "GRAPE_opt_result.pkl")
    kw = dict(J_T=J_T_sm, iter_stop=5, print_iters=False, device="cpu")
    result = optimize_or_load(fn, [traj], tlist, rethrow_exceptions=True,
                              **kw)
    assert result.J_T < 1e-3 and os.path.exists(fn)
    # loading returns the stored result without optimizing again
    reloaded = optimize_or_load(fn, [traj], tlist, **kw)
    assert reloaded.fg_calls == result.fg_calls
    assert abs(reloaded.J_T - result.J_T) < 1e-12
    assert np.allclose(reloaded.optimized_controls[0],
                       result.optimized_controls[0])
    loaded = load_optimization(fn)
    assert loaded.message == result.message and loaded.converged


def test_xgate_global_phase():
    """BASELINE config 2: the X-gate over {|0⟩, |1⟩, |+⟩, |+i⟩} with a
    fluence cost, realised up to one global phase."""
    problem = tls_xgate_problem(iter_stop=20)
    plain = tls_xgate_problem()
    cp = compile_problem(plain.trajectories, plain.tlist, device="cpu",
                         **plain.kwargs)
    assert cp.shared_generator and cp.n_traj == 4 and cp.n_controls == 2
    res = optimize_problem(problem, print_iters=False, device="cpu",
                           rethrow_exceptions=True,
                           check_convergence=lambda r: bool(r.J_T < 1e-4))
    assert res.converged and res.J_T < 1e-3
    assert res.J_a > 0.0  # fluence cost active
    H = problem.trajectories[0].generator
    H_opt = substitute(H, list(zip(get_controls(H),
                                   res.optimized_controls)))
    overlaps = [
        np.vdot(t.target_state, propagate(t.initial_state, H_opt,
                                          problem.tlist, device="cpu"))
        for t in problem.trajectories
    ]
    assert min(abs(o) for o in overlaps) > 0.999
    phases = np.angle(np.asarray(overlaps))
    assert np.ptp((phases - phases[0] + np.pi) % (2 * np.pi)) < 1e-2


@pytest.mark.parametrize("method", ["gradgen", "taylor"])
def test_subspace_gate_problem_matches_reference(method):
    """``two_transmon_subspace_gate_problem`` against the reference's: the
    same compiled arrays (its seeded random target unitary included) and
    the same complex128 evaluation (J 1e-12, gradient 1e-10 of its
    largest entry)."""
    p, p_ref = _subspace(), _subspace(ref_subspace_problem)
    cp = compile_problem(p.trajectories, p.tlist, device="cpu",
                         gradient_method=method, **p.kwargs)
    cp_ref = ref_compile_problem(p_ref.trajectories, p_ref.tlist,
                                 gradient_method=method, **p_ref.kwargs)
    for key in ("psi0", "H0", "ops", "M", "Mfix", "tlist",
                "guess_pulsevals"):
        assert np.array_equal(getattr(cp, key),
                              np.asarray(getattr(cp_ref, key))), key
    assert cp.shared_generator and cp_ref.shared_generator
    assert np.array_equal(
        np.stack([t.target_state for t in p.trajectories]),
        np.stack([t.target_state for t in p_ref.trajectories]))
    x = cp.guess_pulsevals.reshape(-1)
    x = x + 0.05 * np.random.default_rng(3).normal(size=x.shape)
    J, g, _ = build_fg(cp)(x)
    J_ref, g_ref, _ = ref_build_fg(cp_ref)(x)
    g_ref = np.asarray(g_ref)
    assert abs(float(J) - float(J_ref)) < 1e-12
    assert np.abs(g.numpy() - g_ref).max() < 1e-10 * np.abs(g_ref).max()
