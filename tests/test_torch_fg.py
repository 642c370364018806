"""The slice as a whole: ``grape_tpu_torch.build_fg`` against
``grape_tpu.fg.build_fg`` on bit-identical inputs.

The reference compiles the problem; its arrays are read off its
``CompiledProblem`` here and handed to the port through
``compiled_problem_from_numpy``.

Tolerances: complex128 against the reference's XLA path — J to 1e-12,
gradient to 1e-10 relative, the other outputs to 1e-10 (same Padé-13
arithmetic, different order of sums); complex64 against the reference's
Pallas kernels in interpret mode — J to 1e-5, gradient to 2e-3 of its
largest entry (float32 arithmetic over the whole time grid, the tolerances
the reference's own kernel-vs-XLA test uses)."""

import numpy as np
import pytest
import torch

import grape_tpu
from grape_tpu.fg import build_fg as ref_build_fg
from grape_tpu.fg import compile_problem as ref_compile_problem
from grape_tpu.fg import unpack_complex
from grape_tpu.functionals import J_T_sm as ref_J_T_sm
from grape_tpu.models import two_transmon_cz_problem as ref_cz_problem

import grape_tpu_torch
from grape_tpu_torch import (
    build_f, build_fg, compile_problem, compiled_problem_from_numpy,
)
from grape_tpu_torch.models import two_transmon_cz_problem

torch.set_num_threads(1)

AUX_KEYS = {
    "grad_J_Tb", "grad_J_a", "J_parts", "tau", "psi_T", "chi_ok",
    "taylor_ok", "chi_norms",
}


def _arrays_of(cp):
    """The reference's CompiledProblem as plain numpy arrays and scalars."""
    return {
        "psi0": np.asarray(cp.psi0), "H0": np.asarray(cp.H0),
        "ops": np.asarray(cp.ops), "M": np.asarray(cp.M),
        "Mfix": np.asarray(cp.Mfix), "tlist": np.asarray(cp.tlist),
        "guess_pulsevals": np.asarray(cp.guess_pulsevals),
        "ctl_idx": tuple(cp.ctl_idx),
        "shared_generator": bool(cp.shared_generator),
        "norm_cache": cp.norm_cache,
        "target_states": np.stack(
            [np.asarray(t.target_state) for t in cp.trajectories]
        ),
        "weights": [float(t.weight) for t in cp.trajectories],
    }


def _cz_small():
    problem = ref_cz_problem(d=3, n_steps=20, T=5.0)
    return problem.trajectories, problem.tlist


def _random_shared():
    """Seeded random shared-generator problem: d=16, K=3, two controls."""
    rng = np.random.default_rng(42)
    d, K = 16, 3

    def herm(scale):
        A = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
        return scale * 0.5 * (A + A.conj().T)

    H = grape_tpu.hamiltonian(
        herm(0.3),
        (herm(0.5), lambda t: 0.2 * np.cos(0.7 * t)),
        (herm(0.5), lambda t: 0.1 * np.sin(0.9 * t)),
    )
    trajs = []
    for _ in range(K):
        psi0 = rng.normal(size=d) + 1j * rng.normal(size=d)
        tgt = rng.normal(size=d) + 1j * rng.normal(size=d)
        trajs.append(grape_tpu.Trajectory(
            psi0 / np.linalg.norm(psi0), H,
            target_state=tgt / np.linalg.norm(tgt),
        ))
    return trajs, np.linspace(0, 2.0, 13)


PROBLEMS = {"cz_small": _cz_small, "random_shared": _random_shared}


def _pulses(cp):
    x0 = np.asarray(cp.guess_pulsevals).reshape(-1)
    rng = np.random.default_rng(9)
    return {"guess": x0, "perturbed": x0 + 0.05 * rng.normal(size=x0.shape)}


@pytest.fixture(scope="module")
def compiled():
    """Per (problem, dtype): the reference's fg and the port's, built once."""
    cache = {}

    def get(name, dtype):
        key = (name, np.dtype(dtype).name)
        if key not in cache:
            trajs, tlist = PROBLEMS[name]()
            use_pallas = np.dtype(dtype) == np.complex64
            cp_ref = ref_compile_problem(
                trajs, tlist, J_T=ref_J_T_sm, dtype=dtype,
                use_pallas=use_pallas,
            )
            assert cp_ref.shared_generator
            cp = compiled_problem_from_numpy(
                _arrays_of(cp_ref), J_T="J_T_sm", device="cpu"
            )
            cache[key] = (cp_ref, ref_build_fg(cp_ref), cp, build_fg(cp))
        return cache[key]

    return get


@pytest.mark.parametrize("pulse", ["guess", "perturbed"])
@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_fg_complex128_matches_reference(compiled, name, pulse):
    cp_ref, fg_ref, cp, fg = compiled(name, np.complex128)
    x = _pulses(cp_ref)[pulse]
    J_ref, g_ref, aux_ref = fg_ref(x)
    J, g, aux = fg(x)
    assert set(aux) == AUX_KEYS == set(aux_ref)
    assert abs(float(J) - float(J_ref)) < 1e-12
    g, g_ref = g.numpy(), np.asarray(g_ref)
    assert g.shape == g_ref.shape == x.shape
    assert np.max(np.abs(g - g_ref)) < 1e-10 * np.max(np.abs(g_ref))
    for key in ("J_parts", "chi_norms", "grad_J_Tb", "grad_J_a"):
        np.testing.assert_allclose(
            aux[key].numpy(), np.asarray(aux_ref[key]), atol=1e-10, rtol=0
        )
    for key in ("tau", "psi_T"):  # complex here, packed planes there
        np.testing.assert_allclose(
            aux[key].numpy(), unpack_complex(aux_ref[key]), atol=1e-10,
            rtol=0,
        )
    assert bool(aux["chi_ok"]) == bool(aux_ref["chi_ok"]) is True
    assert bool(aux["taylor_ok"]) == bool(aux_ref["taylor_ok"]) is True


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_fg_complex64_matches_reference_kernels(compiled, name):
    """complex64: the port runs the plain versions of its three kernels,
    the reference its three Pallas kernels in interpret mode."""
    from grape_tpu.fg import (
        _pallas_chi_enabled, _pallas_forward_enabled,
        _pallas_gradgen_enabled, _pallas_squarings,
    )
    from grape_tpu_torch.fg import _kernels_enabled, _static_squarings

    cp_ref, fg_ref, cp, fg = compiled(name, np.complex64)
    assert _pallas_forward_enabled(cp_ref, None)
    assert _pallas_chi_enabled(cp_ref) and _pallas_gradgen_enabled(cp_ref)
    assert _kernels_enabled(cp)
    assert _static_squarings(cp) == _pallas_squarings(cp_ref)
    for pulse, x in _pulses(cp_ref).items():
        J_ref, g_ref, _ = fg_ref(x)
        J, g, aux = fg(x)
        g, g_ref = g.numpy(), np.asarray(g_ref)
        assert g.dtype == np.float32
        assert abs(float(J) - float(J_ref)) < 1e-5 * max(1.0, abs(float(J_ref)))
        assert np.max(np.abs(g - g_ref)) < 2e-3 * np.max(np.abs(g_ref)), pulse
        assert aux["psi_T"].dtype == torch.complex64


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_build_f_matches_fg(compiled, name):
    cp_ref, _, cp, fg = compiled(name, np.complex128)
    x = _pulses(cp_ref)["perturbed"]
    J, aux = build_f(cp)(x)
    J2, _, aux2 = fg(x)
    assert float(J) == float(J2)
    assert set(aux) == {"J_parts", "tau", "psi_T"}
    assert torch.equal(aux["psi_T"], aux2["psi_T"])


def test_port_compile_problem_gives_the_reference_arrays():
    """The port's own model through the port's own compile_problem: the
    same arrays as the reference's, exactly."""
    kw = dict(d=3, n_steps=20, T=5.0)
    p_ref = ref_cz_problem(**kw)
    p = two_transmon_cz_problem(**kw)
    for dtype in (np.complex128, np.complex64):
        cp_ref = ref_compile_problem(
            p_ref.trajectories, p_ref.tlist, J_T=ref_J_T_sm, dtype=dtype
        )
        cp = compile_problem(
            p.trajectories, p.tlist, device="cpu", dtype=dtype, **p.kwargs
        )
        for key in ("psi0", "H0", "ops", "M", "Mfix", "tlist",
                    "guess_pulsevals"):
            a, b = np.asarray(getattr(cp, key)), np.asarray(getattr(cp_ref, key))
            assert a.dtype == b.dtype and a.shape == b.shape, key
            assert np.array_equal(a, b), key
        assert cp.ctl_idx == tuple(cp_ref.ctl_idx)
        assert cp.shared_generator and cp_ref.shared_generator
        assert cp.norm_cache["h0"] == cp_ref.norm_cache["h0"]
        assert np.array_equal(cp.norm_cache["ops"], cp_ref.norm_cache["ops"])
        for n in ("n_controls", "n_timesteps", "dim", "n_traj"):
            assert getattr(cp, n) == getattr(cp_ref, n)


def test_gradient_against_finite_differences():
    """The port's complex128 gradient against central differences of its
    own J on the small CZ problem."""
    p = two_transmon_cz_problem(d=3, n_steps=20, T=5.0)
    cp = compile_problem(p.trajectories, p.tlist, device="cpu", **p.kwargs)
    assert cp.psi0.dtype == np.complex128  # the CPU default
    fg, f = build_fg(cp), build_f(cp)
    rng = np.random.default_rng(3)
    x = cp.guess_pulsevals.reshape(-1) + 0.05 * rng.normal(size=80)
    _, g, _ = fg(x)
    g = g.numpy()
    h = 1e-6
    for i in (0, 7, 33, 59, 79):
        e = np.zeros_like(x)
        e[i] = h
        fd = (float(f(x + e)[0]) - float(f(x - e)[0])) / (2 * h)
        assert abs(fd - g[i]) < 1e-8 + 1e-6 * abs(g[i]), i
