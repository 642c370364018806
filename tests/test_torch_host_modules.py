"""The host modules around ``optimize`` through ``grape_tpu_torch``, against
``grape_tpu`` where both have them: ``testing`` (bit-identical seeded
fixtures), ``propagate`` and ``substitute``, ``io`` with ``optimize``'s
``atexit_filename``, ``profile_dir``, ``flops.fg_flops``,
``config.default_float``/``default_complex``, ``set_default_ad_framework``
and the public API.

Tolerances: the fixtures bit for bit (the same draws in the same order);
``propagate`` in complex128 to 1e-12 against the reference (the same
Padé-13 arithmetic), in complex64 through the forward kernel's plain
version to 2e-5 (float32 over the grid); ``fg_flops`` exactly (the same
formulas over the same path selection), except the two deviations its
docstring states, each pinned to its formula.
"""

import json
import os
import pickle
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import grape_tpu
import grape_tpu.flops as ref_flops
import grape_tpu.models as ref_models
import grape_tpu.testing as ref_testing
from grape_tpu.fg import compile_problem as ref_compile_problem

import grape_tpu_torch as gt
import grape_tpu_torch.flops as port_flops
import grape_tpu_torch.models as port_models
import grape_tpu_torch.testing as port_testing
from grape_tpu_torch import config
from grape_tpu_torch.functionals import J_T_sm, set_default_ad_framework
from grape_tpu_torch.io import (
    config_digest, load_result, optimize_or_load, save_result,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --------------------------------------------------------------------------
# testing.py: the same seed gives the same arrays
# --------------------------------------------------------------------------

def _arrays(problem):
    out = {"tlist": np.asarray(problem.tlist)}
    for k, t in enumerate(problem.trajectories):
        out[f"psi0_{k}"] = np.asarray(t.initial_state)
        out[f"tgt_{k}"] = np.asarray(t.target_state)
        gen = t.generator
        out[f"H0_{k}"] = np.asarray(gen.drift)
        for j, (op, _) in enumerate(gen.terms):
            out[f"op_{k}_{j}"] = np.asarray(op)
    controls = gt.get_controls([t.generator for t in problem.trajectories])
    out["guess"] = np.stack([
        gt.discretize_on_midpoints(c, problem.tlist) for c in controls])
    return out


FIXTURES = {
    "dummy_control_problem": lambda m: m.dummy_control_problem(
        N=4, n_trajectories=3, n_controls=2, n_steps=20,
        rng=np.random.default_rng(1244538994)),
    "dummy_default_seed": lambda m: m.dummy_control_problem(N=2),
    "tls_problem": lambda m: m.tls_problem(n_steps=40),
    "stirap_problem": lambda m: m.stirap_problem(lambda_b=0.4, n_steps=40),
    "cnot_problem": lambda m: m.cnot_problem(),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_testing_fixtures_match_reference(name):
    p = FIXTURES[name](port_testing)
    p_ref = FIXTURES[name](ref_testing)
    a, a_ref = _arrays(p), _arrays(p_ref)
    assert a.keys() == a_ref.keys()
    for key in a:
        assert np.array_equal(a[key], a_ref[key]), key
    assert sorted(p.kwargs) == sorted(p_ref.kwargs)
    if "J_T" in p.kwargs:
        assert p.kwargs["J_T"].__name__ == p_ref.kwargs["J_T"].__name__


def test_random_matrix_and_state_match_reference():
    for hermitian in (False, True):
        a = port_testing.random_matrix(7, np.random.default_rng(3),
                                       hermitian=hermitian)
        b = ref_testing.random_matrix(7, np.random.default_rng(3),
                                      hermitian=hermitian)
        assert np.array_equal(a, b)
    assert np.array_equal(
        port_testing.random_state_vector(5, np.random.default_rng(4)),
        ref_testing.random_state_vector(5, np.random.default_rng(4)))


def test_stirap_running_cost_matches_reference():
    """The STIRAP ``g_b`` is a torch function here, a JAX one there: the
    same values on the same states."""
    p = port_testing.stirap_problem(lambda_b=0.4, n_steps=10)
    p_ref = ref_testing.stirap_problem(lambda_b=0.4, n_steps=10)
    rng = np.random.default_rng(8)
    Psi = rng.normal(size=(2, 3)) + 1j * rng.normal(size=(2, 3))
    got = p.kwargs["g_b"](torch.from_numpy(Psi), None, None, 0).numpy()
    ref = np.asarray(p_ref.kwargs["g_b"](Psi, None, None, 0))
    np.testing.assert_allclose(got, ref, rtol=1e-15, atol=0)
    assert p.kwargs["lambda_b"] == p_ref.kwargs["lambda_b"] == 0.4


# --------------------------------------------------------------------------
# propagate and substitute
# --------------------------------------------------------------------------

def _tls_custom(pkg):
    """A TLS with one linear drive and one nonlinear ``A·sin(ε)`` drive."""
    import jax.numpy as jnp

    sz = np.array([[1, 0], [0, -1]], dtype=complex)
    sx = np.array([[0, 1], [1, 0]], dtype=complex)
    sy = np.array([[0, -1j], [1j, 0]], dtype=complex)
    tlist = np.linspace(0, 3, 61)

    def eps(t):
        return 0.3 * np.sin(0.9 * t) + 0.1

    def guess(t):
        return 0.4 * np.cos(0.5 * t)

    if pkg is gt:
        amp = gt.CustomAmplitude(lambda v, t: 1.5 * torch.sin(v[0]), guess,
                                 bound=1.5)
    else:
        amp = grape_tpu.CustomAmplitude(lambda v, t: 1.5 * jnp.sin(v[0]),
                                        guess, bound=1.5)
    H = pkg.hamiltonian(-0.5 * sz, (sx, eps), (sy, amp))
    return H, tlist


def _lindblad(pkg):
    p = (port_models if pkg is gt else ref_models).dissipative_tls_problem(
        n_steps=40)
    t = p.trajectories[0]
    return t.generator, p.tlist, t.initial_state


@pytest.mark.parametrize("storage", [False, True])
@pytest.mark.parametrize("backwards", [False, True])
@pytest.mark.parametrize("model", ["tls_custom", "lindblad"])
def test_propagate_matches_reference(model, backwards, storage):
    if model == "tls_custom":
        (H, tlist), (H_ref, _) = _tls_custom(gt), _tls_custom(grape_tpu)
        psi0 = np.array([1, 0], dtype=complex)
    else:
        H, tlist, psi0 = _lindblad(gt)
        H_ref, _, _ = _lindblad(grape_tpu)
    got = gt.propagate(psi0, H, tlist, storage=storage, backwards=backwards,
                       device="cpu")
    ref = np.asarray(grape_tpu.propagate(psi0, H_ref, tlist, storage=storage,
                                         backwards=backwards))
    assert got.shape == ref.shape and got.dtype == np.complex128
    assert np.abs(got - ref).max() < 1e-12
    # complex64: the forward kernel's plain version, the same function
    got32 = gt.propagate(psi0, H, tlist, storage=storage,
                         backwards=backwards, device="cpu",
                         dtype=np.complex64)
    assert got32.dtype == np.complex64
    assert np.abs(got32 - ref).max() < 2e-5


def test_propagate_static_matrix():
    rng = np.random.default_rng(2)
    A = ref_testing.random_matrix(5, rng)
    psi = ref_testing.random_state_vector(5, rng)
    tlist = np.linspace(0, 1, 11)
    got = gt.propagate(psi, A, tlist, device="cpu")
    ref = np.asarray(grape_tpu.propagate(psi, A, tlist))
    assert np.abs(got - ref).max() < 1e-12


def test_substitute_matches_reference():
    """The linear drive's control is replaced; the nonlinear term keeps its
    own controls, in both packages."""
    H, tlist = _tls_custom(gt)
    H_ref, _ = _tls_custom(grape_tpu)
    controls = gt.get_controls(H)
    controls_ref = grape_tpu.get_controls(H_ref)
    new = np.linspace(0.1, 0.2, len(tlist))
    H2 = gt.substitute(H, [(controls[0], new)])
    H2_ref = grape_tpu.substitute(H_ref, {controls_ref[0]: new})
    assert gt.get_controls(H2) == (new, controls[1])
    assert len(grape_tpu.get_controls(H2_ref)) == 2
    psi0 = np.array([0, 1], dtype=complex)
    got = gt.propagate(psi0, H2, tlist, storage=True, device="cpu")
    ref = np.asarray(grape_tpu.propagate(psi0, H2_ref, tlist, storage=True))
    assert np.abs(got - ref).max() < 1e-12


# --------------------------------------------------------------------------
# io and optimize's atexit_filename
# --------------------------------------------------------------------------

def _tls(n=101):
    p = port_testing.tls_problem(n_steps=n - 1)
    return p.trajectories, p.tlist


def test_save_and_load_round_trip(tmp_path):
    trajs, tlist = _tls()
    res = gt.optimize(trajs, tlist, J_T=J_T_sm, iter_stop=2, device="cpu",
                      print_iters=False)
    fn = str(tmp_path / "sub" / "res.pkl")
    save_result(res, fn, config_digest="abc")
    loaded = load_result(fn)
    assert repr(loaded) == f"GrapeResult<{res.message}> (loaded)"
    assert loaded.config_digest == "abc" and loaded.J_T == res.J_T
    assert loaded.iter == 2 and loaded.message == res.message
    np.testing.assert_array_equal(loaded.optimized_controls[0],
                                  res.optimized_controls[0])
    with open(fn, "rb") as fh:
        data = pickle.load(fh)

    def leaves(v):
        if isinstance(v, dict):
            for u in v.values():
                yield from leaves(u)
        elif isinstance(v, (list, tuple)):
            for u in v:
                yield from leaves(u)
        else:
            yield v

    assert not any(isinstance(v, torch.Tensor) for v in leaves(data))
    # continue_from the loaded file runs on
    res2 = gt.optimize(trajs, tlist, J_T=J_T_sm, iter_stop=4, device="cpu",
                       print_iters=False, continue_from=loaded)
    assert res2.iter == 4 and res2.J_T < res.J_T


def test_saved_tensors_become_numpy(tmp_path):
    trajs, tlist = _tls(11)
    res = gt.GrapeResult(trajs, tlist, {})
    res.tau_vals = torch.ones(1, dtype=torch.complex128)
    res.states = [torch.zeros(2, dtype=torch.complex128)]
    fn = str(tmp_path / "t.pkl")
    save_result(res, fn)
    loaded = load_result(fn)
    assert isinstance(loaded.tau_vals, np.ndarray)
    assert isinstance(loaded.states[0], np.ndarray)


def test_saved_file_loads_without_torch(tmp_path):
    """A saved result is plain Python and numpy: it loads in a process
    that never imports torch (as on a machine without CUDA)."""
    trajs, tlist = _tls(21)
    res = gt.optimize(trajs, tlist, J_T=J_T_sm, iter_stop=1, device="cpu",
                      print_iters=False)
    fn = str(tmp_path / "r.pkl")
    save_result(res, fn)
    code = ("import pickle, sys; d = pickle.load(open(sys.argv[1], 'rb')); "
            "assert 'torch' not in sys.modules, 'torch was imported'; "
            "print(d['iter'], d['message'])")
    out = subprocess.run([sys.executable, "-c", code, fn],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == "1"


def test_optimize_or_load_round_trip_and_stale_digest(tmp_path):
    trajs, tlist = _tls()
    fn = str(tmp_path / "ckpt.pkl")
    kw = dict(J_T=J_T_sm, iter_stop=2, print_iters=False, device="cpu")
    r1 = optimize_or_load(fn, trajs, tlist, **kw)
    assert r1.iter == 2 and os.path.exists(fn)
    # presentation-only keywords do not invalidate the checkpoint
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        r2 = optimize_or_load(fn, trajs, tlist, rethrow_exceptions=True,
                              **kw)
    assert abs(r2.J_T - r1.J_T) < 1e-15 and r2.fg_calls == r1.fg_calls
    # a changed configuration warns and runs again
    with pytest.warns(UserWarning, match="different configuration"):
        r3 = optimize_or_load(fn, trajs, tlist, **dict(kw, iter_stop=3))
    assert r3.iter == 3
    assert load_result(fn).iter == 3


def test_optimize_or_load_resumes_crash_dump(tmp_path):
    trajs, tlist = _tls()
    fn = str(tmp_path / "crashed.pkl")
    kw = dict(J_T=J_T_sm, iter_stop=4, print_iters=False, device="cpu")
    digest = config_digest(trajs, tlist, kw)
    partial = gt.GrapeResult(trajs, tlist, {"iter_stop": 4})
    partial.iter = 1
    partial.optimized_controls = [partial.guess_controls[0] + 0.01]
    save_result(partial, fn, config_digest=digest, interrupted=True)
    with pytest.warns(UserWarning, match="interrupted"):
        r = optimize_or_load(fn, trajs, tlist, **kw)
    assert r.message != "in progress" and r.iter == 4
    # a crash dump of ANOTHER configuration is not resumed
    save_result(partial, fn, config_digest="other", interrupted=True)
    with pytest.warns(UserWarning, match="DIFFERENT configuration"):
        r = optimize_or_load(fn, trajs, tlist, **kw)
    assert r.iter == 4


ATEXIT_SCRIPT = """
import sys
sys.path.insert(0, {root!r})
import grape_tpu_torch as gt
from grape_tpu_torch.functionals import J_T_sm
from grape_tpu_torch.testing import tls_problem

p = tls_problem(n_steps=50)

def stop(wrk, iteration):
    if iteration == 2 and sys.argv[2] == "raise":
        raise RuntimeError("stopped on purpose")

res = gt.optimize(p.trajectories, p.tlist, J_T=J_T_sm, iter_stop=3,
                  device="cpu", print_iters=False, callback=stop,
                  rethrow_exceptions=True, atexit_filename=sys.argv[1],
                  atexit_config_digest="d1")
print(res.iter)
"""


@pytest.mark.parametrize("ending", ["raise", "finish"])
def test_atexit_filename_dump(tmp_path, ending):
    """An exception that escapes ``optimize`` leaves the crash dump
    registered: at exit the in-progress result is saved, tagged
    ``interrupted``, with the digest given.  A finished run releases it:
    nothing is written at exit."""
    script = tmp_path / "run.py"
    script.write_text(ATEXIT_SCRIPT.format(root=ROOT))
    fn = str(tmp_path / "dump.pkl")
    out = subprocess.run([sys.executable, str(script), fn, ending],
                         capture_output=True, text=True, timeout=300)
    if ending == "finish":
        assert out.returncode == 0, out.stderr
        assert out.stdout.split()[-1] == "3" and not os.path.exists(fn)
        return
    assert out.returncode != 0 and "stopped on purpose" in out.stderr
    loaded = load_result(fn)
    assert loaded.interrupted and loaded.config_digest == "d1"
    assert loaded.iter == 2 and loaded.message == "in progress"


def test_profile_dir_writes_a_trace(tmp_path):
    trajs, tlist = _tls(21)
    res = gt.optimize(trajs, tlist, J_T=J_T_sm, iter_stop=1, device="cpu",
                      print_iters=False, profile_dir=str(tmp_path / "prof"))
    assert res.iter == 1
    files = os.listdir(tmp_path / "prof")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(tmp_path / "prof" / files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name") for e in events}
    assert any(n and n.startswith("aten::") for n in names)


# --------------------------------------------------------------------------
# flops.fg_flops
# --------------------------------------------------------------------------

def _cz(m):
    return m.two_transmon_cz_problem(n_steps=100)


def _ensemble(m):
    return m.two_transmon_cz_ensemble_problem(n_samples=8, n_steps=100)


FLOP_CASES = {
    # name: (problem, dtype, keywords for both, keywords for the reference)
    "cz_gradgen": (_cz, np.complex64, {}, {}),
    "cz_gradgen_c128": (_cz, np.complex128, {}, {}),
    "cz_taylor": (_cz, np.complex64, dict(gradient_method="taylor"), {}),
    "cz_taylor_per_step": (_cz, np.complex128, dict(
        gradient_method="taylor", vectorize_backward=False), {}),
    # the reference's kernel route, the one whose bases are per group
    "ensemble_8x4": (_ensemble, np.complex64, {}, dict(use_pallas=True)),
    "ensemble_8x4_taylor": (_ensemble, np.complex64,
                            dict(gradient_method="taylor"), {}),
    "ensemble_recompute": (_ensemble, np.complex64,
                           dict(storage_mode="recompute"),
                           dict(use_pallas=True)),
    "cnot_cheby": (lambda m: (port_testing if m is port_models
                              else ref_testing).cnot_problem(),
                   np.complex128, {}, {}),
    "cz_cheby_taylor": (_cz, np.complex128, dict(
        prop_method="cheby", gradient_method="taylor"), {}),
    "cz_newton": (_cz, np.complex128, dict(prop_method="newton",
                                           newton_m=6), {}),
}


def _flops_pair(build, dtype, kw, ref_kw):
    p, p_ref = build(port_models), build(ref_models)
    cp = gt.compile_problem(p.trajectories, p.tlist, device="cpu",
                            dtype=dtype, **{**p.kwargs, **kw})
    cp_ref = ref_compile_problem(p_ref.trajectories, p_ref.tlist,
                                 dtype=dtype,
                                 **{**p_ref.kwargs, **kw, **ref_kw})
    return port_flops.fg_flops(cp), ref_flops.fg_flops(cp_ref), cp


@pytest.mark.parametrize("name", sorted(FLOP_CASES))
def test_fg_flops_match_reference(name):
    ours, ref, _ = _flops_pair(*FLOP_CASES[name])
    assert ours > 0 and ours == ref


def test_fg_flops_k_blocking_deviation():
    """The reference counts its TPU Fréchet kernel's blocks of 8 padded
    directions, each re-deriving the base; the port counts
    ``(7 + 13K) + s(1 + 2K)`` a step for a shared generator."""
    def sub(m):
        return m.two_transmon_subspace_gate_problem(d=3, n_basis=9,
                                                    n_steps=50, T=10.0)

    ours, ref, cp = _flops_pair(sub, np.complex64, {}, dict(use_pallas=True))
    K, s = cp.n_traj, gt.fg._static_squarings(cp)
    n_grp = -(-K // 8)
    blocked = n_grp * (7 + s) + (13 + 2 * s) * 8 * n_grp
    plain = (7 + 13 * K) + s * (1 + 2 * K)
    assert K == 9 and ours != ref
    assert ref - ours == cp.n_timesteps * (blocked - plain) * 8.0 * cp.dim ** 3
    # without the reference's kernel the two counts agree
    ours2, ref2, _ = _flops_pair(sub, np.complex64, {}, {})
    assert ours2 == ours == ref2


def test_fg_flops_group_base_deviation():
    """The port derives a group's Fréchet base once per (step, group) in
    complex128 too; the reference does so only in its kernel."""
    ours, ref, cp = _flops_pair(_ensemble, np.complex128, {}, {})
    K, gs, s = cp.n_traj, cp.gen_group_size, gt.fg._static_squarings(cp)
    per_step = K * (20 + 3 * s) - ((K // gs) * (7 + s) + K * (13 + 2 * s))
    assert gs == 4 and ref - ours == cp.n_timesteps * per_step * 8.0 * (
        cp.dim ** 3)


# --------------------------------------------------------------------------
# config, set_default_ad_framework, the public API
# --------------------------------------------------------------------------

def test_default_dtypes_follow_the_device():
    assert config.default_complex("cpu") == np.complex128
    assert config.default_float("cpu") == np.float64
    trajs, tlist = _tls(11)
    cp = gt.compile_problem(trajs, tlist, J_T=J_T_sm, device="cpu")
    assert cp.psi0.dtype == config.default_complex("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            config.default_complex()
        with pytest.raises(RuntimeError, match="CUDA"):
            config.default_float()


def test_set_default_ad_framework_is_a_no_op():
    assert gt.set_default_ad_framework is set_default_ad_framework
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert set_default_ad_framework() is None
        assert set_default_ad_framework("Zygote") is None
    with pytest.warns(UserWarning, match="no-op"):
        set_default_ad_framework("Zygote", quiet=False)


# reference modules that the port names after PyTorch
PORT_MODULE_NAMES = {"jax_lbfgs": "torch_lbfgs",
                     "optax_backend": "torch_optim_backend"}
# reference modules not ported yet
NOT_PORTED_YET = set()


def _module_names(pkg):
    import pkgutil

    return {m.name for m in pkgutil.iter_modules(pkg.__path__)}


def test_public_api_covers_the_reference():
    # Krotov's method, the last piece missing until it was ported
    missing = set(grape_tpu.__all__) - set(gt.__all__)
    assert missing == set()
    for name in gt.__all__:
        assert hasattr(gt, name), name
    for mod in ("testing", "flops", "io", "propagate"):
        assert hasattr(gt, mod)
    import grape_tpu_torch.models.open  # noqa: F401
    # the module lists: a backend (or any module) that is missing fails here
    from grape_tpu import optimizers as ref_optimizers
    from grape_tpu import parallel as ref_parallel
    from grape_tpu_torch import optimizers as port_optimizers
    from grape_tpu_torch import parallel as port_parallel

    assert port_parallel.__all__ == ref_parallel.__all__
    for ref_pkg, port_pkg, expected_missing in (
            (grape_tpu, gt, NOT_PORTED_YET),
            (ref_optimizers, port_optimizers, set()),
            (ref_parallel, port_parallel, set())):
        ref_names = {PORT_MODULE_NAMES.get(n, n)
                     for n in _module_names(ref_pkg)}
        assert ref_names - _module_names(port_pkg) == expected_missing
