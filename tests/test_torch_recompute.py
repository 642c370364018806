"""Checkpoint/recompute storage through ``grape_tpu_torch``: the segment
count, recompute against full storage and against the reference's
recompute, on bit-identical problems.

Each package compiles the same model (the port's copies of the reference's
model builders, or the same numpy operators); the reference runs on the
CPU in complex128 (its XLA path), or with ``use_pallas=True`` in complex64
(its Pallas kernels in interpret mode).

Tolerances: complex128 — J to 1e-12, the gradient to 1e-10 of its largest
entry (the same arithmetic, sums in another order; recompute repeats full
storage's arithmetic, so the two agree to rounding); complex64 on the
kernel route against the reference's kernels — J to 1e-5, the gradient to
2e-3 of its largest entry (float32 over the time grid, the reference's own
kernel-vs-XLA tolerance in ``tests/test_storage_recompute.py``)."""

import numpy as np
import pytest
import torch

import grape_tpu
from grape_tpu.fg import _pick_segments as ref_pick_segments
from grape_tpu.fg import build_fg as ref_build_fg
from grape_tpu.fg import compile_problem as ref_compile_problem
from grape_tpu.functionals import J_T_re as ref_J_T_re
from grape_tpu.functionals import J_T_sm as ref_J_T_sm
from grape_tpu.models import (
    two_transmon_cz_ensemble_problem as ref_ensemble_problem,
)
from grape_tpu.models import two_transmon_cz_problem as ref_cz_problem

import grape_tpu_torch
from grape_tpu_torch import build_f, build_fg, compile_problem
from grape_tpu_torch import fg as port_fg
from grape_tpu_torch.fg import _pick_segments
from grape_tpu_torch.functionals import J_T_re, J_T_sm
from grape_tpu_torch.models import (
    two_transmon_cz_ensemble_problem, two_transmon_cz_problem,
)

torch.set_num_threads(1)


def _herm(rng, d, scale):
    A = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    return scale * 0.5 * (A + A.conj().T)


def _unit(rng, d):
    v = rng.normal(size=d) + 1j * rng.normal(size=d)
    return v / np.linalg.norm(v)


def _shared(pkg):
    """The CZ gate at d = 3 (dim 9): four basis states, one generator."""
    problem = (ref_cz_problem if pkg is grape_tpu
               else two_transmon_cz_problem)(d=3, n_steps=24, T=4.0)
    return problem.trajectories, problem.tlist, problem.kwargs


def _grouped(pkg):
    """The robust-CZ ensemble: 2 samples x 4 basis states (dim 9)."""
    problem = (ref_ensemble_problem if pkg is grape_tpu
               else two_transmon_cz_ensemble_problem)(
        n_samples=2, d=3, n_steps=24, T=4.0)
    return problem.trajectories, problem.tlist, problem.kwargs


def _distinct(pkg):
    """Three trajectories with three different generators (d = 6)."""
    rng = np.random.default_rng(17)
    d = 6

    def eps1(t):
        return 0.2 * np.cos(0.7 * t)

    def eps2(t):
        return 0.1 * np.sin(0.9 * t)

    trajs = []
    for _ in range(3):
        H = pkg.hamiltonian(
            _herm(rng, d, 0.3), (_herm(rng, d, 0.5), eps1),
            (_herm(rng, d, 0.5), eps2),
        )
        trajs.append(pkg.Trajectory(_unit(rng, d), H,
                                    target_state=_unit(rng, d)))
    J_T = ref_J_T_sm if pkg is grape_tpu else J_T_sm
    return trajs, np.linspace(0, 2.0, 25), {"J_T": J_T}


_PROBLEMS = {"shared": _shared, "grouped": _grouped, "distinct": _distinct}


def _evaluate(problem, pkg, dtype=np.complex128, **kw):
    trajs, tlist, kwargs = _PROBLEMS[problem](pkg)
    kwargs = {**kwargs, **kw}
    if pkg is grape_tpu:
        cp = ref_compile_problem(trajs, tlist, dtype=dtype, **kwargs)
        x = cp.guess_pulsevals.reshape(-1)
        J, g, aux = ref_build_fg(cp)(x)
        return cp, float(J), np.asarray(g), np.asarray(aux["J_parts"])
    cp = compile_problem(trajs, tlist, dtype=dtype, device="cpu", **kwargs)
    x = cp.guess_pulsevals.reshape(-1)
    J, g, aux = build_fg(cp)(x)
    return cp, float(J), g.numpy(), aux["J_parts"].numpy()


def _close(a, b, J_tol=1e-12, g_tol=1e-10):
    _, Ja, ga, _ = a
    _, Jb, gb, _ = b
    assert abs(Ja - Jb) < J_tol * max(1.0, abs(Jb)), (Ja, Jb)
    scale = max(float(np.max(np.abs(gb))), 1e-12)
    assert float(np.max(np.abs(ga - gb))) < g_tol * scale


def test_pick_segments():
    assert _pick_segments("full", None, 100) == 0
    assert _pick_segments("recompute", None, 100) == 10
    assert _pick_segments("recompute", 25, 100) == 25
    assert _pick_segments("recompute", None, 2000) in (40, 50)
    with pytest.raises(ValueError, match="divide"):
        _pick_segments("recompute", 7, 100)
    for N_T in (1, 2, 7, 24, 36, 400, 2000, 1001):
        assert (_pick_segments("recompute", None, N_T)
                == ref_pick_segments("recompute", None, N_T))


@pytest.mark.parametrize("vectorize", [True, False],
                         ids=["vectorized", "per_step"])
@pytest.mark.parametrize("method", ["gradgen", "taylor"])
@pytest.mark.parametrize("problem", sorted(_PROBLEMS))
def test_recompute_matches_full_and_reference(problem, method, vectorize):
    kw = dict(gradient_method=method, vectorize_backward=vectorize)
    cp, *rec = _evaluate(problem, grape_tpu_torch, storage_mode="recompute",
                         **kw)
    assert cp.storage_segments == 4 and cp.storage_mode == "recompute"
    if vectorize and method == "gradgen":
        assert port_fg._vec_gradgen_enabled(cp)
    full = _evaluate(problem, grape_tpu_torch, **kw)
    ref = _evaluate(problem, grape_tpu, storage_mode="recompute", **kw)
    assert ref[0].storage_segments == cp.storage_segments
    _close((cp, *rec), full)
    _close((cp, *rec), ref)


def test_recompute_taylor_without_stored_propagators():
    """``reuse_propagators=False``: each segment's co-state chain forms
    the propagators again (the U-free chain over a window)."""
    kw = dict(gradient_method="taylor", reuse_propagators=False)
    cp, *rec = _evaluate("grouped", grape_tpu_torch,
                         storage_mode="recompute", **kw)
    assert not port_fg._seg_reuse_U(cp)
    _close((cp, *rec), _evaluate("grouped", grape_tpu_torch, **kw))
    _close((cp, *rec), _evaluate("grouped", grape_tpu,
                                 storage_mode="recompute", **kw))


def test_recompute_kernel_route_matches_reference_kernels():
    """complex64 recompute on the kernel route (the kernels' plain
    versions here, one segment window per call) against the reference's
    recompute with its Pallas kernels in interpret mode, at the
    reference's own test shape (d 4, K 8, N_T 36)."""
    kw = dict(gradient_method="gradgen", storage_mode="recompute")
    problem = ref_ensemble_problem(n_samples=2, d=4, n_steps=36, T=6.0)
    cp_r = ref_compile_problem(problem.trajectories, problem.tlist,
                               use_pallas=True, dtype=np.complex64, **kw,
                               **problem.kwargs)
    x = cp_r.guess_pulsevals.reshape(-1)
    J_r, g_r, _ = ref_build_fg(cp_r)(x)
    mine = two_transmon_cz_ensemble_problem(n_samples=2, d=4, n_steps=36,
                                            T=6.0)
    cp = compile_problem(mine.trajectories, mine.tlist, dtype=np.complex64,
                         device="cpu", **kw, **mine.kwargs)
    assert cp.storage_segments == cp_r.storage_segments == 6
    assert port_fg._kernels_enabled(cp)
    J, g, _ = build_fg(cp)(x)
    _close((cp, float(J), g.numpy(), None),
           (cp_r, float(J_r), np.asarray(g_r), None),
           J_tol=1e-5, g_tol=2e-3)


@pytest.mark.parametrize("problem", ["shared", "grouped"])
def test_recompute_with_state_cost(problem):
    """``J_b`` summed segment by segment and the ξ sources of each
    segment's co-state chain: recompute equals full storage and the
    reference's recompute (J_parts included)."""

    def g_b_np(pkg):
        d = 9
        D = np.diag(np.linspace(0.0, 1.0, d)).astype(complex)
        if pkg is grape_tpu:
            import jax.numpy as jnp

            Dj = jnp.asarray(D)
            return lambda Psi, tr, tl, n: jnp.real(
                jnp.einsum("ki,ij,kj->k", jnp.conj(Psi), Dj, Psi))
        Dt = torch.as_tensor(D)
        return lambda Psi, tr, tl, n: torch.real(
            torch.einsum("ki,ij,kj->k", torch.conj(Psi), Dt, Psi))

    out = {}
    for pkg in (grape_tpu_torch, grape_tpu):
        for mode in ("full", "recompute"):
            J_T = ref_J_T_re if pkg is grape_tpu else J_T_re
            out[pkg.__name__, mode] = _evaluate(
                problem, pkg, storage_mode=mode, g_b=g_b_np(pkg),
                lambda_b=0.3, J_T=J_T)
    rec = out["grape_tpu_torch", "recompute"]
    assert rec[3][2] > 0  # λ_b·J_b
    for key in (("grape_tpu_torch", "full"), ("grape_tpu", "recompute")):
        _close(rec, out[key])
        assert np.allclose(rec[3], out[key][3], rtol=1e-12, atol=1e-14)


def test_fw_prop_callback_under_recompute_raises():
    trajs, tlist, kwargs = _shared(grape_tpu_torch)
    with pytest.raises(ValueError, match="storage_mode='full'"):
        compile_problem(trajs, tlist, storage_mode="recompute",
                        fw_prop_callback=lambda values, tlist: None,
                        device="cpu", **kwargs)
    with pytest.raises(ValueError, match="must divide"):
        compile_problem(trajs, tlist, storage_mode="recompute",
                        storage_segments=7, device="cpu", **kwargs)
    with pytest.raises(ValueError, match="storage_mode"):
        compile_problem(trajs, tlist, storage_mode="disk", device="cpu",
                        **kwargs)


def test_recompute_f_and_optimize():
    """``build_f`` under recompute, and five L-BFGS-B iterations of the
    grouped ensemble equal to full storage's J_T series."""
    trajs, tlist, kwargs = _grouped(grape_tpu_torch)
    cp = compile_problem(trajs, tlist, storage_mode="recompute",
                         device="cpu", **kwargs)
    x = cp.guess_pulsevals.reshape(-1)
    J_f, aux_f = build_f(cp)(x)
    J, _, aux = build_fg(cp)(x)
    assert abs(float(J_f) - float(J)) < 1e-14
    assert torch.allclose(aux_f["psi_T"], aux["psi_T"], atol=1e-14)
    series = {}
    for mode in ("full", "recompute"):
        seen = []
        grape_tpu_torch.optimize(
            trajs, tlist, iter_stop=5, storage_mode=mode, device="cpu",
            print_iters=False, rethrow_exceptions=True,
            callback=lambda wrk, it: seen.append(wrk.J_parts[0]), **kwargs)
        series[mode] = np.asarray(seen)
    assert len(series["full"]) == 6
    assert np.max(np.abs(series["full"] - series["recompute"])) < 1e-10
