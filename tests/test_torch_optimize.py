"""End to end through ``grape_tpu_torch.optimize(..., device="cpu")`` in
complex128: the reference anchors of the TLS state transfer, the golden
J_T series recorded from the JAX package, small robust ensembles against
the JAX package run here (gradgen and taylor), exception capture, and the
options that are not ported yet."""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

import grape_tpu_torch as gt
from grape_tpu_torch import optimize, optimize_problem
from grape_tpu_torch.functionals import J_T_sm
from grape_tpu_torch.models import (
    tls_problem, two_transmon_cz_ensemble_problem, two_transmon_cz_problem,
)

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "traces.json")


def _tls_quickstart():
    def eps(t):
        return 0.2 * float(gt.shapes.flattop(t, T=5, t_rise=0.3,
                                             func="blackman"))

    sz = np.array([[1, 0], [0, -1]], dtype=complex)
    sx = np.array([[0, 1], [1, 0]], dtype=complex)
    H = gt.hamiltonian(-0.5 * sz, (sx, eps))
    tlist = np.linspace(0, 5, 501)
    return [gt.Trajectory([1, 0], H, target_state=[0, 1])], tlist


def test_tls_anchor(capsys):
    trajs, tlist = _tls_quickstart()
    res = optimize(trajs, tlist, iter_stop=5, J_T=J_T_sm, device="cpu")
    assert res.J_T < 1e-3
    assert 0.75 < np.max(np.abs(res.optimized_controls[0])) < 0.85
    assert res.iter == 5 and res.converged
    assert res.message == "Reached maximum number of iterations"
    header = capsys.readouterr().out.splitlines()[0]
    assert header.split() == [
        "iter.", "J_T", "ǁ∇Jǁ", "ǁΔϵǁ", "ΔJ", "FG(F)", "secs",
    ]


def test_bounds_anchor():
    trajs, tlist = _tls_quickstart()
    res = optimize(
        trajs, tlist, iter_stop=5, J_T=J_T_sm, device="cpu",
        lower_bound=-0.7, upper_bound=0.7, print_iters=False,
    )
    assert np.max(np.abs(res.optimized_controls[0])) <= 0.700001
    assert res.J_T < 0.1


def test_tls_golden_trace():
    """The per-iteration J_T series of the JAX package's ``tls_gradgen``
    golden trace, within the band the golden-trace tests use."""
    with open(GOLDEN) as f:
        golden = json.load(f)["tls_gradgen"]
    trace = []
    res = optimize_problem(
        tls_problem(n_steps=500, T=5.0, J_T=J_T_sm, iter_stop=5),
        callback=lambda wrk, it: trace.append(float(wrk.result.J_T)),
        print_iters=False, rethrow_exceptions=True, device="cpu",
    )
    assert len(trace) == len(golden["J_T_trace"])
    np.testing.assert_allclose(
        trace, golden["J_T_trace"], rtol=1e-3, atol=1e-10
    )
    assert res.iter == golden["iter"]
    assert res.converged == golden["converged"]
    assert res.message == golden["message"]
    assert res.J_T < 1e-3


def test_tls_taylor_golden_trace():
    """The ``tls_taylor`` golden series, in the same band."""
    with open(GOLDEN) as f:
        golden = json.load(f)["tls_taylor"]
    trace = []
    res = optimize_problem(
        tls_problem(n_steps=500, T=5.0, J_T=J_T_sm, iter_stop=5),
        callback=lambda wrk, it: trace.append(float(wrk.result.J_T)),
        print_iters=False, rethrow_exceptions=True, device="cpu",
        gradient_method="taylor",
    )
    assert len(trace) == len(golden["J_T_trace"])
    np.testing.assert_allclose(
        trace, golden["J_T_trace"], rtol=1e-3, atol=1e-10
    )
    assert res.iter == golden["iter"]
    assert res.converged == golden["converged"]
    assert res.message == golden["message"]
    assert res.J_T < 1e-3


@pytest.mark.parametrize("options", [
    {}, {"vectorize_backward": False}, {"reuse_propagators": False},
], ids=["vectorized", "per_step", "no_reuse"])
def test_taylor_vs_gradgen_anchor(options):
    """Reference anchor: |ΔJ_T| < 1e-10 between the two gradient methods
    after five iterations, for each of the taylor backward passes."""
    trajs, tlist = _tls_quickstart()
    common = dict(iter_stop=5, J_T=J_T_sm, rethrow_exceptions=True,
                  print_iters=False, device="cpu")
    res_gradgen = optimize(trajs, tlist, gradient_method="gradgen", **common)
    res_taylor = optimize(trajs, tlist, gradient_method="taylor", **common,
                          **options)
    assert res_gradgen.J_T < 1e-3
    assert abs(res_gradgen.J_T - res_taylor.J_T) < 1e-10
    assert res_taylor.fg_calls == res_gradgen.fg_calls


def test_auto_optimizes_to_the_tls_anchor():
    trajs, tlist = _tls_quickstart()
    res = optimize(trajs, tlist, iter_stop=5, J_T=J_T_sm, device="cpu",
                   gradient_method="auto", print_iters=False,
                   rethrow_exceptions=True)
    assert res.J_T < 1e-3
    assert 0.75 < np.max(np.abs(res.optimized_controls[0])) < 0.85


def test_qutrit_ensemble_taylor_matches_reference_series():
    """Five L-BFGS-B iterations on a 16-sample qutrit ensemble with the
    taylor gradient in complex128: the JAX package's J_T series to 1e-8."""
    import grape_tpu
    from grape_tpu.functionals import J_T_sm as ref_J_T_sm
    from grape_tpu.models import (
        transmon_ensemble_trajectories as ref_transmon_ensemble,
    )
    from grape_tpu_torch.models import transmon_ensemble_trajectories

    tlist = np.linspace(0, 20.0, 41)
    ref_trace, trace = [], []
    ref_res = grape_tpu.optimize(
        ref_transmon_ensemble(16, d=3, T=20.0), tlist, J_T=ref_J_T_sm,
        gradient_method="taylor", iter_stop=5, dtype=np.complex128,
        use_pallas=False, print_iters=False, rethrow_exceptions=True,
        callback=lambda wrk, it: ref_trace.append(float(wrk.result.J_T)),
    )
    res = optimize(
        transmon_ensemble_trajectories(16, d=3, T=20.0), tlist, J_T=J_T_sm,
        gradient_method="taylor", iter_stop=5, device="cpu",
        print_iters=False, rethrow_exceptions=True,
        callback=lambda wrk, it: trace.append(float(wrk.result.J_T)),
    )
    assert res.iter == ref_res.iter == 5 and len(trace) == 6
    assert res.fg_calls == ref_res.fg_calls
    np.testing.assert_allclose(trace, ref_trace, rtol=0, atol=1e-8)
    assert all(b < a for a, b in zip(trace, trace[1:])), trace


def test_cz_small_optimizes_in_both_precisions():
    """The gate problem through optimize_problem: complex128 (plain path) and
    complex64 (the kernels' plain versions) both descend, and agree."""
    finals = {}
    for dtype in (np.complex128, np.complex64):
        trace = []
        res = optimize_problem(
            two_transmon_cz_problem(d=3, n_steps=20, T=5.0, iter_stop=3),
            callback=lambda wrk, it: trace.append(float(wrk.result.J_T)),
            print_iters=False, rethrow_exceptions=True, device="cpu",
            dtype=dtype,
        )
        assert all(b < a for a, b in zip(trace, trace[1:])), trace
        assert res.fg_calls >= 4
        finals[dtype] = trace
    np.testing.assert_allclose(
        finals[np.complex64], finals[np.complex128], rtol=1e-3
    )


ENSEMBLE_KW = dict(n_samples=2, d=4, T=4.0, n_steps=12)


def test_ensemble_optimization_matches_reference_series():
    """Five L-BFGS-B iterations on a small robust-CZ ensemble (2 samples x
    4 basis states, dim 16) in complex128: the JAX package's J_T series to
    1e-8 (the same host optimizer fed gradients that agree to 1e-10)."""
    import grape_tpu
    from grape_tpu.models import (
        two_transmon_cz_ensemble_problem as ref_ensemble_problem,
    )

    ref_trace, trace = [], []
    ref_res = grape_tpu.optimize_problem(
        ref_ensemble_problem(**ENSEMBLE_KW), iter_stop=5,
        dtype=np.complex128, use_pallas=False, print_iters=False,
        rethrow_exceptions=True,
        callback=lambda wrk, it: ref_trace.append(float(wrk.result.J_T)),
    )
    res = optimize_problem(
        two_transmon_cz_ensemble_problem(**ENSEMBLE_KW), iter_stop=5,
        device="cpu", print_iters=False, rethrow_exceptions=True,
        callback=lambda wrk, it: trace.append(float(wrk.result.J_T)),
    )
    assert res.iter == ref_res.iter == 5 and len(trace) == 6
    assert res.fg_calls == ref_res.fg_calls
    np.testing.assert_allclose(trace, ref_trace, rtol=0, atol=1e-8)
    assert all(b < a for a, b in zip(trace, trace[1:])), trace


def test_ensemble_optimizes_in_complex64():
    """The same ensemble through the kernels' plain versions (complex64):
    it descends, and follows the complex128 series."""
    traces = {}
    for dtype in (np.complex128, np.complex64):
        trace = traces.setdefault(dtype, [])
        res = optimize_problem(
            two_transmon_cz_ensemble_problem(**ENSEMBLE_KW), iter_stop=3,
            device="cpu", dtype=dtype, print_iters=False,
            rethrow_exceptions=True,
            callback=lambda wrk, it: trace.append(float(wrk.result.J_T)),
        )
        assert res.iter == 3
        assert all(b < a for a, b in zip(trace, trace[1:])), trace
        assert not res.message.startswith("Exception")
    np.testing.assert_allclose(
        traces[np.complex64], traces[np.complex128], rtol=1e-3
    )


def test_envelope_bucket_sees_per_trajectory_tables():
    """The squaring count comes from the coefficient envelope over ALL
    trajectories' tables: a member with a 64x larger amplitude shape raises
    it for the whole problem."""
    from grape_tpu_torch.fg import _static_squarings

    def eps(t):
        return 0.5

    rng = np.random.default_rng(2)
    A = rng.normal(size=(4, 4))
    Hc = A + A.T + 0j
    counts = []
    for big in (1.0, 64.0):
        trajs = [
            gt.Trajectory(
                [1, 0, 0, 0],
                gt.hamiltonian(np.diag([0.0, 1, 2, 3]).astype(complex),
                               (Hc, gt.ShapedAmplitude(
                                   eps, lambda t, w=w: w))),
                target_state=[0, 1, 0, 0],
            )
            for w in (1.0, big)
        ]
        cp = gt.compile_problem(trajs, np.linspace(0, 2.0, 5), J_T=J_T_sm,
                                device="cpu", dtype=np.complex64)
        assert cp.per_traj_coeffs == (big != 1.0)
        counts.append(_static_squarings(cp))
    assert counts[1] >= counts[0] + 5


def test_exception_is_captured_in_the_message():
    trajs, tlist = _tls_quickstart()

    def J_T_bad(Psi, trajectories):
        raise ValueError("boom")

    res = optimize(trajs, tlist, iter_stop=2, J_T=J_T_bad, device="cpu",
                   print_iters=False)
    assert res.message.startswith("Exception:") and "boom" in res.message
    with pytest.raises(ValueError, match="boom"):
        optimize(trajs, tlist, iter_stop=2, J_T=J_T_bad, device="cpu",
                 print_iters=False, rethrow_exceptions=True)


def test_check_convergence_and_records():
    trajs, tlist = _tls_quickstart()
    res = optimize(
        trajs, tlist, iter_stop=20, J_T=J_T_sm, device="cpu",
        print_iters=False, store_iter_info=["iter.", "J_T"],
        check_convergence=lambda r: "J_T < 0.03" if r.J_T < 0.03 else "",
    )
    assert res.converged and res.message == "J_T < 0.03"
    assert res.iter == 2
    assert [r[0] for r in res.records] == [0, 1, 2]


def _excited_population(Psi, trajectories, tlist, n):
    return 1e-3 * Psi[..., 1].abs() ** 2


# options that raised until they were ported: their cases stay, under the
# same ids, and now hold the option to what it does
PORTED = {
    "eval_device_calls": 4,
    "gradient_method": "taylor",
    "reuse_propagators": False,
    "taylor_grad_max_order": 50,
    "prop_method": "cheby",
    "fw_prop_method": "newton",
    "storage_mode": "recompute",
    "g_b": _excited_population,
    "xi": lambda Psi, trajectories, tlist, n: -1e-3 * Psi * torch.tensor(
        [0.0, 1.0], dtype=Psi.real.dtype),
    "fw_prop_callback": lambda values, tlist: None,
    "optimizer": "scipy-lbfgsb",
    # made in the test: a DeviceMesh needs a process group (a gloo world
    # of one)
    "mesh": None,
}
# what a ported option's run also takes: a Krylov space that fits the TLS;
# the running cost that an xi belongs to
PORTED_WITH = {"fw_prop_method": {"newton_m": 6},
               "xi": {"g_b": _excited_population},
               "eval_device_calls": {"storage_mode": "recompute"}}
# options the workspace holds rather than the compiled problem
WORKSPACE_OPTIONS = ("optimizer", "eval_device_calls")


@contextlib.contextmanager
def _cpu_mesh_of_one(path):
    from grape_tpu_torch import parallel

    parallel.init_distributed(f"file://{path}/store", 1, 0, device="cpu",
                              timeout=30)
    try:
        yield parallel.make_mesh(device="cpu")
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("option", sorted(PORTED))
def test_unported_option_raises(option, tmp_path):
    """Every option that once raised ``NotImplementedError`` has been
    ported (``PORTED``) and is honoured: the run reaches the TLS anchor and
    the compiled problem (or the workspace) carries it."""
    trajs, tlist = _tls_quickstart()
    kw = dict(J_T=J_T_sm, device="cpu", print_iters=False,
              rethrow_exceptions=True)
    if option != "gradient_method":
        kw["gradient_method"] = "taylor"
    seen = []
    kw.update(PORTED_WITH.get(option, {}))
    with contextlib.ExitStack() as stack:
        value = PORTED[option]
        if option == "mesh":
            value = stack.enter_context(_cpu_mesh_of_one(tmp_path))
        res = optimize(trajs, tlist, iter_stop=5, **kw,
                       callback=lambda wrk, it: seen.append(wrk),
                       **{option: value})
    assert res.J_T < 1e-3 and res.message.startswith("Reached maximum")
    # the compiled problem carries the option; the workspace the backend's
    holder = seen[0] if option in WORKSPACE_OPTIONS else seen[0].cp
    assert getattr(holder, option) == value
    assert seen[0].cp.gradient_method == "taylor"


def _case(entry, option, value, raised_before=False):
    """A case of ``REFERENCE_DEFAULTS`` under the id it has always had; a
    value that raised until the keyword was ported keeps its ``-False``
    id and now holds the keyword to being taken."""
    return pytest.param(entry, option, value,
                        id=f"{entry}-{option}-{value}-{not raised_before}")


REFERENCE_DEFAULTS = [
    # (entry point, keyword, value): every value the reference takes for
    # its TPU keywords is taken (what each does: tests/test_torch_keywords.py)
    _case("compile_problem", "use_pallas", "auto"),
    _case("compile_problem", "use_pallas", False, raised_before=True),
    _case("compile_problem", "use_pallas", True, raised_before=True),
    _case("compile_problem", "gradgen_pallas_precision", "high"),
    _case("compile_problem", "gradgen_pallas_precision", "highest",
          raised_before=True),
    _case("optimize", "use_pallas", "auto"),
    _case("optimize", "use_pallas", False, raised_before=True),
    _case("optimize", "gradgen_pallas_precision", "high"),
    _case("optimize", "gradgen_pallas_precision", "default",
          raised_before=True),
    _case("optimize", "prewarm_envelope", True),
    _case("optimize", "prewarm_envelope", False, raised_before=True),
]


@pytest.mark.parametrize("entry,option,value", REFERENCE_DEFAULTS)
def test_reference_defaults_of_tpu_keywords(entry, option, value):
    trajs, tlist = _tls_quickstart()
    tlist = tlist[:51]
    if entry == "compile_problem":
        out = gt.compile_problem(trajs, tlist, J_T=J_T_sm, device="cpu",
                                 **{option: value})
        assert out.n_timesteps == 50 and getattr(out, option) == value
    else:
        out = optimize(trajs, tlist, J_T=J_T_sm, device="cpu", iter_stop=1,
                       print_iters=False, rethrow_exceptions=True,
                       **{option: value})
        assert out.iter == 1 and np.isfinite(out.J_T)


def _keyword(option, value, raised_before=False):
    """A case of ``OPTIMIZE_KEYWORDS`` under the id it has always had."""
    return pytest.param(option, value,
                        id=f"{option}-{value}-{not raised_before}")


OPTIMIZE_KEYWORDS = [
    # (keyword, value): keywords of grape_tpu.optimize that the port once
    # refused, each accepted now; such a case keeps the id it had while the
    # keyword was refused.  eval_device_calls since build_fg_multicall was
    # ported (it needs recompute storage, as in the reference)
    _keyword("eval_device_calls", 2, raised_before=True),
    # since the device loop was ported (ignored by the default backend on
    # the CPU, as by the reference's)
    _keyword("device_loop_iters", 8, raised_before=True),
    # with no effect since the parallel module was ported (the port always
    # holds the operator arrays in device memory)
    _keyword("max_embedded_constant_bytes", 1 << 20, raised_before=True),
    _keyword("atexit_filename", "dump.pkl"),
    _keyword("atexit_config_digest", "abc"),
    _keyword("profile_dir", "prof"),
]


@pytest.mark.parametrize("option,value", OPTIMIZE_KEYWORDS)
def test_optimize_keywords_refused_or_accepted(tmp_path, option, value):
    trajs, tlist = _tls_quickstart()
    if option in ("atexit_filename", "profile_dir"):
        value = str(tmp_path / value)
    kw = dict(J_T=J_T_sm, device="cpu", iter_stop=1, print_iters=False,
              rethrow_exceptions=True)
    if option == "eval_device_calls":
        kw["storage_mode"] = "recompute"
    res = optimize(trajs, tlist[:51], **kw, **{option: value})
    assert res.iter == 1 and np.isfinite(res.J_T)
    if option == "atexit_filename":
        assert not os.path.exists(value)  # a finished run dumps nothing
    if option == "profile_dir":
        assert len(os.listdir(value)) == 1


def test_unported_constructs_raise(monkeypatch):
    trajs, tlist = _tls_quickstart()
    # nonlinear amplitudes construct and compile since they were ported
    amp = gt.CustomAmplitude(lambda v, t: v[0] ** 2, lambda t: 0.1)
    cp_c = gt.compile_problem(
        [gt.Trajectory([1, 0], gt.hamiltonian(
            np.diag([0.5, -0.5]).astype(complex),
            (np.array([[0, 1], [1, 0]], dtype=complex), amp)),
            target_state=[0, 1])],
        tlist, J_T=J_T_sm, device="cpu")
    assert [j for j, _, _ in cp_c.custom_terms] == [0]
    # Krotov's method, refused until it was ported, now dispatches
    kres = optimize_problem(tls_problem(J_T=J_T_sm, n_steps=50),
                            method="krotov", device="cpu", iter_stop=1,
                            print_iters=False, rethrow_exceptions=True)
    assert isinstance(kres, gt.KrotovResult) and kres.iter == 1
    # two different Hamiltonians (per-trajectory generators, aligned to the
    # union of their controls) compile; with a complex128 propagator stream
    # beyond its storage budget they take the per-step backward pass
    H2 = gt.hamiltonian(
        np.diag([0.3, -0.3]).astype(complex),
        (np.array([[0, 1], [1, 0]], dtype=complex), lambda t: 0.1),
    )
    other = gt.Trajectory([0, 1], H2, target_state=[1, 0])
    cp = gt.compile_problem(trajs + [other], tlist, J_T=J_T_sm, device="cpu")
    assert not cp.shared_generator and cp.H0.shape[0] == 2
    assert cp.n_controls == 2 and cp.ops.shape[1] == 2
    from grape_tpu_torch import fg as port_fg

    x = cp.guess_pulsevals.reshape(-1)[::1].copy()
    J, g, _ = gt.build_fg(cp)(x)
    monkeypatch.setattr(port_fg, "_gg_u_bytes_ok", lambda cp: False)
    assert not port_fg._vec_gradgen_enabled(cp)
    J2, g2, aux2 = gt.build_fg(cp)(x)  # the per-step pass
    assert abs(float(J2) - float(J)) < 1e-13
    assert float((g2 - g).abs().max()) < 1e-10 * float(g.abs().max())
    assert bool(aux2["taylor_ok"])
    with pytest.raises(TypeError, match="no_such_option"):
        optimize(trajs, tlist, J_T=J_T_sm, device="cpu", print_iters=False,
                 rethrow_exceptions=True, no_such_option=1)
