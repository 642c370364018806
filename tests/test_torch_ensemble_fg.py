"""The ensemble slice as a whole: ``grape_tpu_torch.build_fg`` against
``grape_tpu.fg.build_fg`` on bit-identical inputs, for trajectories that do
not share one generator.

Four kinds of problem: the robust-CZ gate ensemble (groups of 4
trajectories per Hamiltonian sample), distinct generators per trajectory,
per-trajectory coefficient tables (amplitude shapes that differ), and an
ensemble whose term lists differ and are padded by ``align_generators``.
The reference compiles each; its arrays are read off its
``CompiledProblem`` and handed to the port through
``compiled_problem_from_numpy``.

Tolerances: complex128 against the reference's XLA path — J to 1e-12,
gradient to 1e-10 relative (same Padé-13 arithmetic, different order of
sums); complex64 against the reference's Pallas kernels in interpret mode —
J to 1e-5, gradient to 2e-3 of its largest entry (float32 arithmetic over
the whole time grid, the tolerances the reference's own kernel-vs-XLA tests
use)."""

import numpy as np
import pytest
import torch

import grape_tpu
from grape_tpu.fg import build_fg as ref_build_fg
from grape_tpu.fg import compile_problem as ref_compile_problem
from grape_tpu.functionals import J_T_sm as ref_J_T_sm
from grape_tpu.functionals import (
    make_ensemble_gate_functional as ref_ensemble_functional,
)
from grape_tpu.models import (
    two_transmon_cz_ensemble_problem as ref_ensemble_problem,
)

import grape_tpu_torch
from grape_tpu_torch import (
    build_f, build_fg, compile_problem, compiled_problem_from_numpy,
)
from grape_tpu_torch import fg as port_fg
from grape_tpu_torch.functionals import make_ensemble_gate_functional
from grape_tpu_torch.models import two_transmon_cz_ensemble_problem
from grape_tpu_torch.ops import hopper_prop

torch.set_num_threads(1)

ENSEMBLE_KW = dict(n_samples=2, d=4, T=4.0, n_steps=12)  # dim 16, K = 8


def _arrays_of(cp):
    """The reference's CompiledProblem as plain numpy arrays and scalars."""
    return {
        "psi0": np.asarray(cp.psi0), "H0": np.asarray(cp.H0),
        "ops": np.asarray(cp.ops), "M": np.asarray(cp.M),
        "Mfix": np.asarray(cp.Mfix), "tlist": np.asarray(cp.tlist),
        "guess_pulsevals": np.asarray(cp.guess_pulsevals),
        "ctl_idx": tuple(cp.ctl_idx),
        "shared_generator": bool(cp.shared_generator),
        "per_traj_coeffs": bool(cp.per_traj_coeffs),
        "gen_group_size": int(cp.gen_group_size),
        "ops_grouped": bool(cp.ops_grouped),
        "norm_cache": cp.norm_cache,
        "target_states": np.stack(
            [np.asarray(t.target_state) for t in cp.trajectories]
        ),
        "weights": [float(t.weight) for t in cp.trajectories],
    }


def _herm(rng, d, scale):
    A = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    return scale * 0.5 * (A + A.conj().T)


def _unit(rng, d):
    v = rng.normal(size=d) + 1j * rng.normal(size=d)
    return v / np.linalg.norm(v)


def _grouped(pkg):
    """The robust-CZ ensemble model: 2 samples x 4 basis states."""
    problem = (ref_ensemble_problem if pkg is grape_tpu
               else two_transmon_cz_ensemble_problem)(**ENSEMBLE_KW)
    return problem.trajectories, problem.tlist


def _distinct(pkg):
    """Three trajectories, three different drifts and drive operators,
    one shared pair of controls: d = 16."""
    rng = np.random.default_rng(17)
    d, K = 16, 3

    def eps1(t):
        return 0.2 * np.cos(0.7 * t)

    def eps2(t):
        return 0.1 * np.sin(0.9 * t)

    trajs = []
    for _ in range(K):
        H = pkg.hamiltonian(
            _herm(rng, d, 0.3), (_herm(rng, d, 0.5), eps1),
            (_herm(rng, d, 0.5), eps2),
        )
        trajs.append(pkg.Trajectory(
            _unit(rng, d), H, target_state=_unit(rng, d)
        ))
    return trajs, np.linspace(0, 2.0, 13)


def _per_traj_coeffs(pkg):
    """One drift and one drive operator, but an amplitude shape that
    differs per trajectory: per-trajectory coefficient tables."""
    rng = np.random.default_rng(31)
    d, K = 16, 3

    def eps(t):
        return 0.2 * np.cos(0.5 * t)

    Hc, H0 = _herm(rng, d, 0.4), _herm(rng, d, 0.3)
    trajs = []
    for k in range(K):
        H = pkg.hamiltonian(
            H0, (Hc, pkg.ShapedAmplitude(eps, lambda t, k=k: 1.0 + 0.1 * k))
        )
        trajs.append(pkg.Trajectory(
            _unit(rng, d), H, target_state=_unit(rng, d)
        ))
    return trajs, np.linspace(0, 2.0, 13)


def _padded(pkg):
    """Only the second and third members carry a crosstalk drive, so the
    term lists differ and ``align_generators`` pads them."""
    rng = np.random.default_rng(53)
    d, K = 16, 3

    def eps(t):
        return 0.2 * np.cos(0.6 * t)

    def xtalk(t):
        return 0.05 * np.sin(1.1 * t)

    Hc, Hx = _herm(rng, d, 0.5), _herm(rng, d, 0.4)
    trajs = []
    for k in range(K):
        parts = [_herm(rng, d, 0.3), (Hc, eps)]
        if k > 0:
            parts.append(((1.0 + 0.2 * k) * Hx, xtalk))
        trajs.append(pkg.Trajectory(
            _unit(rng, d), pkg.hamiltonian(*parts),
            target_state=_unit(rng, d),
        ))
    return trajs, np.linspace(0, 2.0, 13)


# name -> (problem function, expected (H0 leading axis, gen_group_size,
# ops_grouped, per_traj_coeffs), ensemble functional?)
PROBLEMS = {
    "grouped": (_grouped, (2, 4, True, False), True),
    "distinct": (_distinct, (3, 1, False, False), False),
    "per_traj_coeffs": (_per_traj_coeffs, (3, 1, False, True), False),
    "padded": (_padded, (3, 1, False, False), False),
}


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
            make, _, ensemble = PROBLEMS[name]
            trajs, tlist = make(grape_tpu)
            cp_ref = ref_compile_problem(
                trajs, tlist, dtype=dtype,
                J_T=ref_ensemble_functional(4) if ensemble else ref_J_T_sm,
                use_pallas=np.dtype(dtype) == np.complex64,
            )
            cp = compiled_problem_from_numpy(
                _arrays_of(cp_ref), device="cpu",
                J_T=make_ensemble_gate_functional(4) if ensemble
                else "J_T_sm",
            )
            cache[key] = (cp_ref, ref_build_fg(cp_ref), cp, build_fg(cp))
        return cache[key]

    return get


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_reference_problem_is_of_its_kind(compiled, name):
    cp_ref, _, cp, _ = compiled(name, np.complex128)
    n_gen, gs, grouped, per_traj = PROBLEMS[name][1]
    for c in (cp_ref, cp):
        assert not c.shared_generator
        assert c.H0.shape[0] == n_gen and c.ops.shape[0] == n_gen
        assert c.gen_group_size == gs and c.ops_grouped == grouped
        assert c.per_traj_coeffs == per_traj
        assert np.asarray(c.M).ndim == (4 if per_traj else 3)
    assert port_fg._effective_group_size(cp) == gs
    assert port_fg._stored_u_entries(cp) == cp.n_traj // gs
    if name == "padded":
        # the first member's crosstalk operator is the zero padding
        assert cp.ops.shape[1] == 2 and not cp.ops[0, 1].any()
        assert cp.ops[1, 1].any()


@pytest.mark.parametrize("pulse", ["guess", "perturbed"])
@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_ensemble_fg_complex128_matches_reference(compiled, name, pulse):
    cp_ref, fg_ref, cp, fg = compiled(name, np.complex128)
    x = _pulses(cp_ref)[pulse]
    J_ref, g_ref, aux_ref = fg_ref(x)
    J, g, aux = fg(x)
    assert set(aux) == set(aux_ref)
    assert abs(float(J) - float(J_ref)) < 1e-12
    g, g_ref = g.numpy(), np.asarray(g_ref)
    assert g.shape == g_ref.shape == x.shape
    assert np.max(np.abs(g - g_ref)) < 1e-10 * np.max(np.abs(g_ref))
    for key in ("J_parts", "chi_norms", "grad_J_Tb"):
        np.testing.assert_allclose(
            aux[key].numpy(), np.asarray(aux_ref[key]), atol=1e-10, rtol=0
        )


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_ensemble_fg_complex64_matches_reference_kernels(compiled, name):
    """complex64: the port runs the plain versions of its kernels, the
    reference its Pallas kernels in interpret mode (the per-trajectory
    Fréchet kernel for all four; the grouped or per-trajectory forward
    kernel where the coefficient table is shared)."""
    from grape_tpu.fg import (
        _pallas_forward_enabled, _pallas_gradgen_pertraj_enabled,
        _pallas_squarings,
    )

    cp_ref, fg_ref, cp, fg = compiled(name, np.complex64)
    assert _pallas_gradgen_pertraj_enabled(cp_ref)
    assert _pallas_forward_enabled(cp_ref, None) == (
        name != "per_traj_coeffs"
    )
    assert port_fg._kernels_enabled(cp)
    assert port_fg._static_squarings(cp) == _pallas_squarings(cp_ref)
    for pulse, x in _pulses(cp_ref).items():
        J_ref, g_ref, _ = fg_ref(x)
        J, g, aux = fg(x)
        g, g_ref = g.numpy(), np.asarray(g_ref)
        assert g.dtype == np.float32
        assert abs(float(J) - float(J_ref)) < 1e-5 * max(1.0, abs(float(J_ref)))
        assert np.max(np.abs(g - g_ref)) < 2e-3 * np.max(np.abs(g_ref)), pulse
        assert aux["psi_T"].dtype == torch.complex64


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_u_free_route_matches_stored_u_route(compiled, name, monkeypatch):
    """With the propagator stream declared too large, complex64 forms the
    propagators again window by window for the χ chain: the same J and
    gradient to 1e-5 as over the stored stream.  complex128 has no kernel
    to form them again and takes the per-step backward pass: the same
    gradient as its vectorized pass to 1e-10 relative."""
    cp_ref, _, cp, fg = compiled(name, np.complex64)
    # built here, within budget: the vectorized pass
    _, _, cp128, fg128 = compiled(name, np.complex128)
    x = _pulses(cp_ref)["perturbed"]
    J, g, _ = fg(x)
    monkeypatch.setattr(port_fg, "_gg_u_bytes_ok", lambda cp: False)
    G = port_fg._stored_u_entries(cp)
    monkeypatch.setattr(hopper_prop, "_WINDOW_BYTES",
                        5 * G * cp.dim * cp.dim * 8)  # 5 steps per window
    J2, g2, _ = build_fg(cp)(x)
    assert abs(float(J2) - float(J)) < 1e-5
    assert float((g2 - g).abs().max()) < 1e-5
    Jf, _ = build_f(cp)(x)
    assert abs(float(Jf) - float(J)) < 1e-5
    assert not port_fg._vec_gradgen_enabled(cp128)
    J128, g128, _ = fg128(x)
    J3, g3, aux3 = build_fg(cp128)(x)
    assert abs(float(J3) - float(J128)) < 1e-13
    assert float((g3 - g128).abs().max()) < 1e-10 * float(g128.abs().max())
    assert bool(aux3["taylor_ok"])


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64],
                         ids=["complex128", "complex64"])
def test_port_compile_problem_gives_the_reference_arrays(dtype):
    """The port's own ensemble model through the port's own
    compile_problem: the reference's arrays, exactly, and its flags; so for
    the three seeded problems built from the port's own classes."""
    for name, (make, _, ensemble) in PROBLEMS.items():
        trajs_ref, tlist = make(grape_tpu)
        trajs, _ = make(grape_tpu_torch)
        cp_ref = ref_compile_problem(
            trajs_ref, tlist, dtype=dtype,
            J_T=ref_ensemble_functional(4) if ensemble else ref_J_T_sm,
        )
        cp = compile_problem(
            trajs, tlist, device="cpu", dtype=dtype,
            J_T=make_ensemble_gate_functional(4) if ensemble
            else grape_tpu_torch.functionals.J_T_sm,
        )
        for key in ("psi0", "H0", "ops", "M", "Mfix", "tlist",
                    "guess_pulsevals"):
            a, b = np.asarray(getattr(cp, key)), np.asarray(getattr(cp_ref, key))
            assert a.dtype == b.dtype and a.shape == b.shape, (name, key)
            assert np.array_equal(a, b), (name, key)
        assert cp.ctl_idx == tuple(cp_ref.ctl_idx)
        for flag in ("shared_generator", "per_traj_coeffs", "gen_group_size",
                     "ops_grouped", "n_controls", "n_timesteps", "dim",
                     "n_traj"):
            assert getattr(cp, flag) == getattr(cp_ref, flag), (name, flag)
        assert cp.norm_cache["h0"] == cp_ref.norm_cache["h0"]
        assert np.array_equal(cp.norm_cache["ops"], cp_ref.norm_cache["ops"])


def test_equal_generators_under_distinct_objects_are_shared():
    """The content-equality fallback: K generator objects with equal arrays
    compile to one shared generator, as in the reference."""
    for pkg in (grape_tpu, grape_tpu_torch):
        rng = np.random.default_rng(5)
        H0, Hc = _herm(rng, 4, 0.3), _herm(rng, 4, 0.5)

        def eps(t):
            return 0.1

        trajs = [
            pkg.Trajectory(_unit(rng, 4), pkg.hamiltonian(H0, (Hc, eps)),
                           target_state=_unit(rng, 4))
            for _ in range(3)
        ]
        tlist = np.linspace(0, 1.0, 5)
        if pkg is grape_tpu:
            cp = ref_compile_problem(trajs, tlist, J_T=ref_J_T_sm)
        else:
            cp = compile_problem(trajs, tlist, device="cpu",
                                 J_T=grape_tpu_torch.functionals.J_T_sm)
        assert cp.shared_generator and cp.H0.shape[0] == 1
        assert cp.gen_group_size == 1 and not cp.ops_grouped


def test_group_detection_with_operators_stored_per_trajectory(compiled):
    """A problem handed over with one operator entry per trajectory but a
    group size (equal arrays in runs): the port computes per group and
    gives the grouped result."""
    cp_ref, _, cp, fg = compiled("grouped", np.complex128)
    arrays = _arrays_of(cp_ref)
    arrays["H0"] = np.repeat(arrays["H0"], 4, axis=0)
    arrays["ops"] = np.repeat(arrays["ops"], 4, axis=0)
    arrays["ops_grouped"] = False
    arrays["norm_cache"] = None
    cp_k = compiled_problem_from_numpy(
        arrays, device="cpu", J_T=make_ensemble_gate_functional(4)
    )
    assert cp_k.H0.shape[0] == 8 and port_fg._effective_group_size(cp_k) == 4
    consts = port_fg._device_constants(cp_k, torch.device("cpu"))
    assert consts["H0"].shape[0] == 2
    x = _pulses(cp_ref)["perturbed"]
    J, g, _ = fg(x)
    J_k, g_k, _ = build_fg(cp_k)(x)
    assert float(J_k) == float(J) and torch.equal(g_k, g)
    # no group size: one expm per trajectory, the same numbers to rounding
    arrays["gen_group_size"] = 1
    cp_1 = compiled_problem_from_numpy(
        arrays, device="cpu", J_T=make_ensemble_gate_functional(4)
    )
    assert port_fg._stored_u_entries(cp_1) == 8
    J_1, g_1, _ = build_fg(cp_1)(x)
    assert abs(float(J_1) - float(J)) < 1e-13
    assert float((g_1 - g).abs().max()) < 1e-13


def test_convert_refuses_inconsistent_shapes(compiled):
    cp_ref = compiled("grouped", np.complex128)[0]
    arrays = _arrays_of(cp_ref)
    bad = dict(arrays, ops_grouped=False)  # 2 entries for 8 trajectories
    with pytest.raises(ValueError, match="H0 must be"):
        compiled_problem_from_numpy(bad, device="cpu", J_T="J_T_sm")
    bad = dict(arrays, gen_group_size=3)
    with pytest.raises(ValueError, match="does not divide"):
        compiled_problem_from_numpy(bad, device="cpu", J_T="J_T_sm")
    bad = dict(arrays, per_traj_coeffs=True)
    with pytest.raises(ValueError, match="M must be"):
        compiled_problem_from_numpy(bad, device="cpu", J_T="J_T_sm")


@pytest.mark.parametrize("name", ["grouped", "per_traj_coeffs"])
def test_ensemble_gradient_against_finite_differences(compiled, name):
    """The port's complex128 gradient against central differences of its
    own J."""
    cp_ref, _, cp, fg = compiled(name, np.complex128)
    f = build_f(cp)
    x = _pulses(cp_ref)["perturbed"]
    _, g, _ = fg(x)
    g = g.numpy()
    h = 1e-6
    for i in (0, 5, len(x) // 2, len(x) - 1):
        e = np.zeros_like(x)
        e[i] = h
        fd = (float(f(x + e)[0]) - float(f(x - e)[0])) / (2 * h)
        assert abs(fd - g[i]) < 1e-8 + 1e-6 * abs(g[i]), i
