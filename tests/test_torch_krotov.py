"""Krotov's method in ``grape_tpu_torch`` against ``grape_tpu``.

The cases of the reference's ``tests/test_krotov.py`` on the port (complex128
on the CPU), each run beside the reference's ``optimize_krotov`` where the
numbers can be compared: the J_T series to 1e-10 of the series' largest
value and the final pulses to 1e-10 of their largest value.  (The series is
held relative to its scale, not value by value: ``J_T = 1 - |τ|²`` cancels,
and at J_T ≈ 3e-6 one rounding of ``|τ|²`` is already 4e-11 of J_T; the two
packages' series differ there by 4.5e-15.)  The sweep takes one squaring
count per sweep where the reference takes each step's own, which moves
complex128 results at rounding level only.  Then continuation both ways
with continuous records, ``update_shape``, the per-trajectory generator
ensemble, the refusals, exception capture, ``optimize_problem`` dispatch,
the reload through ``io``, and the two deliberate deviations from the
reference: ``continue_from`` a finished run, and an unsupported
``store_iter_info`` label."""

import numpy as np
import pytest
import torch

import grape_tpu
import grape_tpu.models
from grape_tpu.shapes import flattop as ref_flattop

import grape_tpu_torch as gt
from grape_tpu_torch import KrotovResult, optimize, optimize_krotov
from grape_tpu_torch.controls import discretize_on_midpoints
from grape_tpu_torch.functionals import J_T_sm
from grape_tpu_torch.shapes import flattop

torch.set_num_threads(1)

SZ = np.array([[1, 0], [0, -1]], dtype=complex)
SX = np.array([[0, 1], [1, 0]], dtype=complex)


def guess_eps(t):
    return 0.2 * float(flattop(t, T=5.0, t_rise=0.3, func="blackman"))


def _tls(pkg):
    H = pkg.hamiltonian(-0.5 * SZ, (SX, guess_eps))
    return ([pkg.Trajectory([1, 0], H, target_state=[0, 1])],
            np.linspace(0, 5, 501))


def _run(pkg, trajs, tlist, **kw):
    """``optimize_krotov`` of ``pkg`` with the J_T series of its callback:
    ``(result, series)``."""
    Js = []
    extra = {"device": "cpu"} if pkg is gt else {}
    res = pkg.optimize_krotov(
        trajs, tlist, J_T=pkg.functionals.J_T_sm, print_iters=False,
        rethrow_exceptions=True, callback=lambda r, i: Js.append(r.J_T),
        **extra, **kw)
    return res, np.asarray(Js)


def _assert_matches_reference(make, **kw):
    """The port's series and final pulses against the reference's on the
    same problem; returns the port's ``(result, series)``."""
    res, Js = _run(gt, *make(gt), **kw)
    res_r, Js_r = _run(grape_tpu, *make(grape_tpu), **kw)
    assert Js.shape == Js_r.shape
    assert np.max(np.abs(Js - Js_r)) < 1e-10 * np.max(np.abs(Js_r))
    for c, c_r in zip(res.optimized_controls, res_r.optimized_controls):
        c_r = np.asarray(c_r)
        assert np.max(np.abs(c - c_r)) < 1e-10 * max(np.max(np.abs(c_r)),
                                                     1e-300)
    assert res.iter == res_r.iter and res.message == res_r.message
    return res, Js


def test_krotov_tls_monotonic_matches_reference():
    """TLS |0⟩→|1⟩, λ_a = 2, 10 iterations: monotonic descent to
    J_T < 1e-3, the guess recorded at iteration 0 and left untouched, the
    series and the pulses equal to the reference's."""
    res, Js = _assert_matches_reference(_tls, lambda_a=2.0, iter_stop=10)
    assert isinstance(res, KrotovResult)
    assert res.J_T < 1e-3 and res.iter == 10 and Js[0] > 0.9
    assert all(b <= a + 1e-12 for a, b in zip(Js, Js[1:])), Js
    tlist = _tls(gt)[1]
    assert np.allclose(res.guess_controls[0], [guess_eps(t) for t in tlist])
    assert not np.allclose(res.optimized_controls[0], res.guess_controls[0])
    assert res.message == "Reached maximum number of iterations"


def test_krotov_to_grape_continuation():
    """Krotov→GRAPE: GRAPE continues from the KrotovResult itself, with
    the warm-start pulse, continuous iteration numbers and the Krotov
    records as the prefix; the first GRAPE row holds Krotov's final J_T."""
    trajs, tlist = _tls(gt)
    kres = optimize_krotov(
        trajs, tlist, J_T=J_T_sm, lambda_a=2.0, iter_stop=3,
        store_iter_info=["iter.", "J_T"], print_iters=False,
        rethrow_exceptions=True, device="cpu")
    assert isinstance(kres, KrotovResult) and kres.iter == 3
    J_k = kres.J_T
    assert 1e-6 < J_k < 0.9
    records_before = list(kres.records)
    assert [r[0] for r in records_before] == [0, 1, 2, 3]
    res = optimize(
        trajs, tlist, J_T=J_T_sm, iter_stop=8, continue_from=kres,
        store_iter_info=["iter.", "J_T"], print_iters=False,
        rethrow_exceptions=True, device="cpu")
    assert res.J_T < 1e-3 and res.J_T < J_k and res.iter > 3
    assert res.records[:4] == records_before and len(res.records) > 4
    assert abs(res.records[4][1] - J_k) < 1e-12


def test_grape_to_krotov_continuation():
    """GRAPE→Krotov: Krotov continues the GRAPE result, numbering on from
    its iterations, and lowers J_T further."""
    trajs, tlist = _tls(gt)
    gres = optimize(trajs, tlist, J_T=J_T_sm, iter_stop=2,
                    print_iters=False, rethrow_exceptions=True,
                    store_iter_info=["iter.", "J_T"], device="cpu")
    J_g = gres.J_T
    assert J_g < 0.9
    res = optimize_krotov(
        trajs, tlist, J_T=J_T_sm, lambda_a=2.0, iter_stop=5,
        continue_from=gres, store_iter_info=["iter.", "J_T"],
        print_iters=False, rethrow_exceptions=True, device="cpu")
    assert isinstance(res, KrotovResult)
    assert res.J_T < J_g and res.iter == 5
    assert [r[0] for r in res.records] == [0, 1, 2, 2, 3, 4, 5]
    assert abs(res.records[3][1] - J_g) < 1e-12


def test_krotov_update_shape_gates_update():
    """S ≡ 0 freezes the pulse; a flattop S keeps the first and last
    interval at their guess values, and the pulses equal the
    reference's."""
    trajs, tlist = _tls(gt)
    guess_mid = discretize_on_midpoints(guess_eps, tlist)
    res0 = optimize_krotov(trajs, tlist, J_T=J_T_sm, lambda_a=2.0,
                           iter_stop=2, update_shape=lambda t: 0.0,
                           print_iters=False, rethrow_exceptions=True,
                           device="cpu")
    assert np.allclose(
        discretize_on_midpoints(res0.optimized_controls[0], tlist),
        guess_mid)

    def shape(t):
        return float(ref_flattop(t, T=5.0, t_rise=0.5, func="blackman"))

    res1, _ = _assert_matches_reference(_tls, lambda_a=2.0, iter_stop=3,
                                        update_shape=shape)
    du = discretize_on_midpoints(res1.optimized_controls[0], tlist) - guess_mid
    assert abs(du[0]) < 1e-10 and abs(du[-1]) < 1e-10
    assert np.max(np.abs(du)) > 1e-3


def _ensemble(pkg):
    trajs = pkg.models.transmon_ensemble_trajectories(4, d=3, T=4.0)
    return trajs, np.linspace(0.0, 4.0, 41)


def test_krotov_ensemble_per_traj_generators():
    """Per-trajectory generators (the update sums the overlaps over all
    trajectories): the guess infidelity halves, monotonically, and the
    series equals the reference's."""
    res, Js = _assert_matches_reference(_ensemble, lambda_a=0.5,
                                        iter_stop=12)
    assert np.isfinite(res.J_T) and res.J_T < 0.5 * Js[0]
    assert all(b <= a + 1e-12 for a, b in zip(Js, Js[1:])), Js


def _xgate(pkg):
    problem = pkg.models.tls_xgate_problem(n_steps=200)
    return problem.trajectories, problem.tlist


def test_krotov_shared_generator_gate():
    """The X-gate (four basis states under ONE generator, two controls):
    J_T below 0.05 after 15 iterations, monotonic, equal to the
    reference's."""
    res, Js = _assert_matches_reference(_xgate, lambda_a=1.0, iter_stop=15)
    assert res.J_T < 0.05, res.J_T
    assert all(b <= a + 1e-12 for a, b in zip(Js, Js[1:])), Js


def _g_b(Psi, trajectories, tlist, n):
    return torch.zeros(Psi.shape[0], dtype=Psi.real.dtype)


REFUSED = {
    "g_b": (dict(g_b=_g_b, lambda_b=1.0), "running cost"),
    "custom_amplitude": ({}, "CustomAmplitude"),
    "upper_bound": (dict(upper_bound=0.5), "upper_bound"),
    "pulse_options": (None, "pulse_options"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_krotov_refuses_out_of_scope(case):
    """The reference's limitations, each refused by name."""
    trajs, tlist = _tls(gt)
    kw, match = REFUSED[case]
    if case == "custom_amplitude":
        amp = gt.CustomAmplitude(lambda v, t: v[0] ** 2, lambda t: 0.1)
        trajs = [gt.Trajectory([1, 0], gt.hamiltonian(-0.5 * SZ, (SX, amp)),
                               target_state=[0, 1])]
    if case == "pulse_options":
        control = trajs[0].generator.terms[0][1]
        kw = dict(pulse_options={control: {"upper_bounds": 0.5}})
    with pytest.raises(NotImplementedError, match=match):
        optimize_krotov(trajs, tlist, J_T=J_T_sm, print_iters=False,
                        device="cpu", **kw)


def test_krotov_exception_capture():
    """An exception in the callback ends the run with the message
    "Exception: ...", or propagates with ``rethrow_exceptions``."""
    trajs, tlist = _tls(gt)
    tlist = tlist[:101]

    def bad_cb(res, iteration):
        if iteration >= 1:
            raise RuntimeError("boom")

    res = optimize_krotov(trajs, tlist, J_T=J_T_sm, iter_stop=3,
                          callback=bad_cb, print_iters=False, device="cpu")
    assert res.message == "Exception: boom" and res.iter == 1
    with pytest.raises(RuntimeError):
        optimize_krotov(trajs, tlist, J_T=J_T_sm, iter_stop=3,
                        callback=bad_cb, print_iters=False, device="cpu",
                        rethrow_exceptions=True)


def test_optimize_problem_method_dispatch():
    """``optimize_problem(method="krotov")`` runs Krotov's method; an
    unknown method raises."""
    trajs, tlist = _tls(gt)
    problem = gt.ControlProblem(trajs, tlist[:101], J_T=J_T_sm)
    res = gt.optimize_problem(problem, method="krotov", lambda_a=2.0,
                              iter_stop=2, print_iters=False,
                              rethrow_exceptions=True, device="cpu")
    assert isinstance(res, KrotovResult) and res.iter == 2
    with pytest.raises(ValueError, match="Unknown optimization method"):
        gt.optimize_problem(problem, method="qaoa", device="cpu")


def test_continue_from_finished_run_returns_at_once():
    """Deviation from the reference (which reports "in progress"): a
    ``continue_from`` whose ``iter`` has reached ``iter_stop`` returns at
    once, converged, with the message of a finished run, and runs no
    iteration."""
    trajs, tlist = _tls(gt)
    tlist = tlist[:101]
    kres = optimize_krotov(trajs, tlist, J_T=J_T_sm, iter_stop=2,
                           print_iters=False, device="cpu")
    before = np.array(kres.optimized_controls[0])
    seen = []
    res = optimize_krotov(trajs, tlist, J_T=J_T_sm, iter_stop=2,
                          continue_from=kres, print_iters=False,
                          callback=lambda r, i: seen.append(i),
                          device="cpu")
    assert res.converged and res.iter == 2 and not seen
    assert res.message == "Reached maximum number of iterations"
    assert np.array_equal(res.optimized_controls[0], before)


def test_unsupported_label_raises_before_the_loop():
    """Deviation from the reference (which swallows it into
    ``result.message``): an unsupported ``store_iter_info`` label raises
    ``ValueError`` before any iteration, even without
    ``rethrow_exceptions``."""
    trajs, tlist = _tls(gt)
    seen = []
    with pytest.raises(ValueError, match="store_iter_info label"):
        optimize_krotov(trajs, tlist, J_T=J_T_sm, iter_stop=2,
                        store_iter_info=["iter.", "ǁ∇Jǁ"],
                        callback=lambda r, i: seen.append(i),
                        print_iters=False, device="cpu")
    assert not seen


def test_krotov_result_reloads_as_krotov_result(tmp_path):
    """``io.save_result`` / ``load_result``: a Krotov result reloads as a
    ``KrotovResult`` with its fields, and GRAPE continues from it."""
    trajs, tlist = _tls(gt)
    tlist = tlist[:101]
    kres = optimize_krotov(trajs, tlist, J_T=J_T_sm, iter_stop=2,
                           store_iter_info=["iter.", "J_T"],
                           print_iters=False, device="cpu")
    fn = str(tmp_path / "krotov.pkl")
    gt.save_result(kres, fn)
    back = gt.load_result(fn)
    assert type(back) is KrotovResult and back.method == "krotov"
    assert back.iter == 2 and back.J_T == kres.J_T
    assert back.records == kres.records
    assert np.array_equal(back.optimized_controls[0],
                          kres.optimized_controls[0])
    res = optimize(trajs, tlist, J_T=J_T_sm, iter_stop=3, continue_from=back,
                   print_iters=False, rethrow_exceptions=True, device="cpu")
    assert res.iter == 3 and res is back


def test_sweep_squaring_count_is_one_decision_per_iteration():
    """The sweep's exponentials take one squaring count, decided once per
    iteration on the host from the norm bound, which holds for the new
    pulse: one decision (no regrown bound) on the TLS."""
    from grape_tpu_torch import krotov

    trajs, tlist = _tls(gt)
    cp = gt.compile_problem(trajs, tlist, J_T=J_T_sm, device="cpu")
    S = np.ones((1, cp.n_timesteps))
    step = krotov._build_krotov_step(cp, S, np.array([2.0]))
    J_old, eps_new, J_new, _, _ = step(cp.guess_pulsevals.reshape(-1))
    assert J_new < J_old
    stats = step.stats
    assert stats["squaring_decisions"] == 1
    bound = krotov._SquaringBound(cp, S / 2.0)
    assert stats["squarings"] >= bound.squarings(np.abs(eps_new).max(1))
    assert np.all(np.abs(eps_new).max(1) <= stats["amplitude_bound"])
