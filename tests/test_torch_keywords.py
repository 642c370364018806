"""The reference's last keywords through ``grape_tpu_torch``:
``eval_device_calls`` (``fg.build_fg_multicall``), ``use_pallas``,
``gradgen_pallas_precision`` and ``prewarm_envelope``.

``build_fg_multicall`` is ``build_fg`` under the reference's contract
(its refusals, ``n_calls`` grown to divide the segments): the port holds
the two to the reference's own limits (J to 1e-13 relative, the gradient
to 1e-12 of its largest entry, ``J_parts`` to 1e-14; in fact the same
bits), and the reference's
``build_fg_multicall`` on the same problem to 1e-12 / 1e-10 (complex128,
sums in another order).  ``use_pallas=False`` in complex64 runs the plain
path, held to the reference's ``use_pallas=False`` build (its XLA path) to
1e-5 in J and 1e-3 of the gradient's largest entry (float32 over 60
steps, the repo's complex64 limits).  The other keywords change no
arithmetic: the same bits."""

import numpy as np
import pytest
import torch

from grape_tpu.fg import build_fg_multicall as ref_build_fg_multicall
from grape_tpu.fg import compile_problem as ref_compile_problem
from grape_tpu.models import (
    two_transmon_cz_ensemble_problem as ref_ensemble_problem,
)

import grape_tpu_torch as gt
from grape_tpu_torch import fg as port_fg
from grape_tpu_torch.fg import build_fg, build_fg_multicall, compile_problem
from grape_tpu_torch.functionals import J_T_sm
from grape_tpu_torch.models import two_transmon_cz_ensemble_problem
from grape_tpu_torch.shapes import flattop

torch.set_num_threads(1)


def _tiny(pkg_problem=two_transmon_cz_ensemble_problem):
    """The reference's multicall case: 2 samples x 4 basis states of the
    CZ at d = 3, 60 steps (``tests/test_storage_recompute.py``)."""
    return pkg_problem(n_samples=2, d=3, n_steps=60, T=10.0)


def _kw(problem, **kw):
    out = {k: v for k, v in problem.kwargs.items() if k != "iter_stop"}
    out.update(kw)
    return out


def _cp(method, **kw):
    p = _tiny()
    return compile_problem(p.trajectories, p.tlist, device="cpu",
                           **_kw(p, gradient_method=method,
                                 storage_mode="recompute", **kw))


def _ref_cp(method, **kw):
    p = _tiny(ref_ensemble_problem)
    return ref_compile_problem(p.trajectories, p.tlist,
                               **_kw(p, gradient_method=method,
                                     storage_mode="recompute", **kw))


@pytest.mark.parametrize("method,n_calls", [("gradgen", 3), ("taylor", 2),
                                            ("gradgen", 4)])
def test_multicall_matches_build_fg_and_reference(method, n_calls):
    cp = _cp(method)
    x = cp.guess_pulsevals.reshape(-1)
    J1, g1, aux1 = build_fg(cp)(x)
    J2, g2, aux2 = build_fg_multicall(cp, n_calls=n_calls)(x)
    assert abs(float(J2) - float(J1)) <= 1e-13 * max(1.0, abs(float(J1)))
    scale = float(g1.abs().max())
    assert float((g2 - g1).abs().max()) <= 1e-12 * scale
    assert float((aux2["J_parts"] - aux1["J_parts"]).abs().max()) <= 1e-14
    assert bool(aux2["chi_ok"]) and bool(aux2["taylor_ok"])
    assert set(aux2) == set(aux1)
    Jr, gr, auxr = ref_build_fg_multicall(_ref_cp(method),
                                          n_calls=n_calls)(x)
    assert abs(float(J2) - float(Jr)) < 1e-12
    assert np.max(np.abs(g2.numpy() - np.asarray(gr))) < 1e-10 * scale
    assert bool(auxr["chi_ok"]) and bool(auxr["taylor_ok"])


def test_multicall_blocks_grow_to_divide_the_segments():
    """S = 6 segments here: 4 calls grow to 6, 3 and 1 stay; every
    segment is visited once, last first."""
    cp = _cp("gradgen")
    assert cp.storage_segments == 6
    assert [build_fg_multicall(cp, n_calls=n).n_calls
            for n in (4, 3, 1)] == [6, 3, 1]
    with pytest.raises(ValueError, match="at least 1"):
        build_fg_multicall(cp, n_calls=0)
    seen = []
    orig = port_fg._backward_window

    def spy(cp_, consts, coeffs, dM, psis, Us, chi, rho, safe_rho, amp_max,
            pds, n0, *rest):
        seen.append(n0)
        return orig(cp_, consts, coeffs, dM, psis, Us, chi, rho, safe_rho,
                    amp_max, pds, n0, *rest)

    x = cp.guess_pulsevals.reshape(-1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_fg, "_backward_window", spy)
        build_fg_multicall(cp, n_calls=4)(x)
    assert seen == [50, 40, 30, 20, 10, 0]


def test_multicall_more_calls_than_segments():
    """More calls than the 6 segments are taken as one segment a call (the
    reference's growth would never end) and give ``build_fg``'s bits."""
    cp = _cp("gradgen")
    x = cp.guess_pulsevals.reshape(-1)
    fg = build_fg_multicall(cp, n_calls=7)
    assert fg.n_calls == cp.storage_segments == 6
    J1, g1, _ = build_fg(cp)(x)
    J2, g2, _ = fg(x)
    assert float(J2) == float(J1) and torch.equal(g2, g1)


def test_multicall_refusals_match_reference():
    p = _tiny()
    full = compile_problem(p.trajectories, p.tlist, device="cpu",
                           **_kw(p, gradient_method="gradgen"))
    with pytest.raises(ValueError, match="recompute storage"):
        build_fg_multicall(full)
    per_step = _cp("taylor", vectorize_backward=False)
    with pytest.raises(ValueError, match="segment-vectorized"):
        build_fg_multicall(per_step)
    pr = _tiny(ref_ensemble_problem)
    with pytest.raises(ValueError, match="recompute storage"):
        ref_build_fg_multicall(ref_compile_problem(
            pr.trajectories, pr.tlist, **_kw(pr, gradient_method="gradgen")))
    with pytest.raises(ValueError, match="segment-vectorized"):
        ref_build_fg_multicall(_ref_cp("taylor", vectorize_backward=False))


def _trace(**kw):
    p = _tiny()
    seen = []
    res = gt.optimize_problem(
        p, iter_stop=3, device="cpu", storage_mode="recompute",
        print_iters=False, rethrow_exceptions=True,
        callback=lambda wrk, it: seen.append((wrk.result.J_T, wrk)), **kw)
    return [j for j, _ in seen], seen[0][1], res


def test_optimize_eval_device_calls_gives_the_default_trace():
    base, _, _ = _trace()
    split, wrk, res = _trace(eval_device_calls=2)
    assert split == base and len(base) == 4
    assert wrk.eval_device_calls == 2 and res.iter == 3


def _tls(n_steps=60):
    def eps(t):
        return 0.2 * float(flattop(t, T=5, t_rise=0.3, func="blackman"))

    sz = np.array([[1, 0], [0, -1]], dtype=complex)
    sx = np.array([[0, 1], [1, 0]], dtype=complex)
    H = gt.hamiltonian(-0.5 * sz, (sx, eps))
    return ([gt.Trajectory([1, 0], H, target_state=[0, 1])],
            np.linspace(0, 5, n_steps + 1))


def _fg_at_guess(dtype, **kw):
    p = _tiny()
    cp = compile_problem(p.trajectories, p.tlist, device="cpu", dtype=dtype,
                         **_kw(p, **kw))
    x = cp.guess_pulsevals.reshape(-1)
    J, g, _ = build_fg(cp)(x)
    return cp, float(J), g


def test_use_pallas_false_complex128_gives_the_default_bits():
    _, J0, g0 = _fg_at_guess(np.complex128)
    cp, J1, g1 = _fg_at_guess(np.complex128, use_pallas=False)
    assert cp.use_pallas is False
    assert J1 == J0 and torch.equal(g1, g0)


def test_use_pallas_false_complex64_runs_no_kernel_and_matches_reference():
    """No kernel wrapper is called (each raises here if it were), and the
    plain complex64 path agrees with the reference's ``use_pallas=False``
    build."""
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel wrapper was called")

    with pytest.MonkeyPatch.context() as mp:
        for name in ("forward_scan_grouped", "forward_scan_shared",
                     "forward_scan_pertraj", "chi_scan_grouped",
                     "frechet_trace_pertraj", "frechet_trace_shared"):
            mp.setattr(port_fg, name, refuse)
        cp, J, g = _fg_at_guess(np.complex64, use_pallas=False)
    assert not port_fg._kernels_enabled(cp)
    p = _tiny(ref_ensemble_problem)
    from grape_tpu.fg import build_fg as ref_build_fg

    rcp = ref_compile_problem(p.trajectories, p.tlist, dtype=np.complex64,
                              use_pallas=False, **_kw(p))
    Jr, gr, _ = ref_build_fg(rcp)(cp.guess_pulsevals.reshape(-1))
    assert abs(J - float(Jr)) < 1e-5
    assert (np.max(np.abs(g.double().numpy() - np.asarray(gr)))
            < 1e-3 * float(g.abs().max()))


def test_use_pallas_true_equals_auto_and_bad_values_raise():
    cp_a, J_a, g_a = _fg_at_guess(np.complex64)
    cp_t, J_t, g_t = _fg_at_guess(np.complex64, use_pallas=True)
    assert port_fg._kernels_enabled(cp_t) and port_fg._kernels_enabled(cp_a)
    assert J_t == J_a and torch.equal(g_t, g_a)
    trajs, tlist = _tls()
    for bad in ("yes", 1, None):
        with pytest.raises(ValueError, match="use_pallas"):
            compile_problem(trajs, tlist, J_T=J_T_sm, device="cpu",
                            use_pallas=bad)


def test_gradgen_pallas_precision_values_give_the_same_bits():
    _, J0, g0 = _fg_at_guess(np.complex64)
    for prec in ("highest", "default"):
        cp, J, g = _fg_at_guess(np.complex64,
                                gradgen_pallas_precision=prec)
        assert cp.gradgen_pallas_precision == prec
        assert J == J0 and torch.equal(g, g0)
    trajs, tlist = _tls()
    with pytest.raises(ValueError, match="unknown precision"):
        compile_problem(trajs, tlist, J_T=J_T_sm, device="cpu",
                        gradgen_pallas_precision="low")
    with pytest.raises(ValueError, match="unknown precision"):
        gt.optimize(trajs, tlist, J_T=J_T_sm, device="cpu", iter_stop=1,
                    gradgen_pallas_precision="medium", print_iters=False,
                    rethrow_exceptions=True)


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_prewarm_envelope_gives_the_same_trace(dtype):
    trajs, tlist = _tls()
    traces = []
    for prewarm in (True, False):
        tr = []
        gt.optimize(trajs, tlist, J_T=J_T_sm, device="cpu", dtype=dtype,
                    iter_stop=4, prewarm_envelope=prewarm, print_iters=False,
                    rethrow_exceptions=True,
                    callback=lambda wrk, it: tr.append(wrk.result.J_T))
        traces.append(tr)
    assert traces[0] == traces[1] and len(traces[0]) == 5


def test_use_pallas_reaches_every_partition_and_krotov_drops_it():
    """Mixed propagators: each partition is compiled with the caller's
    ``use_pallas``; Krotov drops the caller's value, as the reference
    does, and runs."""
    trajs, tlist = _tls(n_steps=40)
    t0 = trajs[0]
    mixed = [gt.Trajectory(t0.initial_state, t0.generator,
                           target_state=t0.target_state, prop_method=m)
             for m in ("cheby", "expprop")]
    seen = []
    gt.optimize(mixed, tlist, J_T=J_T_sm, device="cpu", dtype=np.complex64,
                use_pallas=False, iter_stop=1, print_iters=False,
                rethrow_exceptions=True,
                callback=lambda wrk, it: seen.append(wrk.cp))
    assert [p.use_pallas for p in seen[0].parts] == [False, False]
    res = gt.optimize_krotov(trajs, tlist, J_T=J_T_sm, device="cpu",
                             use_pallas=False, iter_stop=2,
                             print_iters=False, rethrow_exceptions=True)
    assert res.iter == 2 and np.isfinite(res.J_T)
