"""The small-dimension ensemble path on the CPU: the plain version of
``forward_scan_smalld`` against the Pallas kernel it replaces
(``forward_scan_pallas_smalld`` in interpret mode) on the same seeded inputs,
the host helper ``taylor_order_for_bound`` against the reference's, the
routing gate against the reference's, and the wrapper's input checks.

The plain version repeats the CUDA kernel's arithmetic (degree-16 Taylor by
Paterson-Stockmeyer, static ``s``) and is what ``chip_smoke.py`` holds the
CUDA kernel against on the card.  Tolerance: 2e-5 absolute on unit-norm
states and propagators (float32 arithmetic on both sides, the Pallas kernel
with Karatsuba products, the port with 4-multiply ones)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from grape_tpu import fg as ref_fg_mod
from grape_tpu.fg import build_f as ref_build_f
from grape_tpu.fg import build_fg as ref_build_fg
from grape_tpu.fg import compile_problem as ref_compile_problem
from grape_tpu.functionals import J_T_sm as ref_J_T_sm
from grape_tpu.models import (
    transmon_ensemble_trajectories as ref_transmon_ensemble,
)
from grape_tpu.ops.pallas_prop import forward_scan_pallas_smalld
from grape_tpu.ops.pallas_prop import (
    taylor_order_for_bound as ref_taylor_order_for_bound,
)

import grape_tpu_torch as gt
from grape_tpu_torch import build_f, build_fg, compiled_problem_from_numpy
from grape_tpu_torch import fg as port_fg
from grape_tpu_torch.functionals import J_T_sm
from grape_tpu_torch.models import transmon_ensemble_trajectories
from grape_tpu_torch.ops import hopper_prop
from grape_tpu_torch.ops.hopper_prop import (
    forward_scan_pertraj_plain, forward_scan_smalld,
    forward_scan_smalld_plain, taylor_order_for_bound,
)

from tests.test_torch_ensemble_fg import _arrays_of, _pulses

torch.set_num_threads(1)

N_T, T = 6, 2


def _inputs(d, K, seed, hscale):
    rng = np.random.default_rng(seed)
    H0 = rng.normal(size=(K, d, d)) + 1j * rng.normal(size=(K, d, d))
    H0 = hscale * 0.5 * (H0 + np.conj(np.swapaxes(H0, -1, -2)))
    ops = rng.normal(size=(K, T, d, d)) + 1j * rng.normal(size=(K, T, d, d))
    ops = 0.5 * (ops + np.conj(np.swapaxes(ops, -1, -2)))
    coeffs = (0.3 * rng.normal(size=(N_T, T))).astype(np.float32)
    dts = (0.1 * (1 + 0.2 * rng.uniform(size=N_T))).astype(np.float32)
    psi0 = rng.normal(size=(K, d)) + 1j * rng.normal(size=(K, d))
    psi0 /= np.linalg.norm(psi0, axis=1, keepdims=True)
    c64 = np.complex64
    return H0.astype(c64), ops.astype(c64), coeffs, dts, psi0.astype(c64)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# (d, K, s): d in {2, 3, 4}, K below and above one vector of 128 lanes,
# s in {0, 1, 2}.  Not the full grid: the unrolled Pallas kernel takes from
# half a minute to several minutes to compile for the CPU at d = 4 with
# squarings, and the plain version's code does not depend on d.
SCAN_CASES = [
    (2, 8, 0), (2, 8, 1), (2, 130, 2), (3, 8, 0), (3, 8, 2), (3, 130, 1),
    (4, 8, 0), (4, 130, 0),
]


@pytest.mark.parametrize("d,K,s", SCAN_CASES)
def test_forward_scan_smalld_plain_matches_pallas_kernel(d, K, s):
    # hscale keeps |dt| ||H|| 2^-s within the Taylor polynomial's range
    arrays = _inputs(d, K, seed=100 * d + K + s, hscale=2.0 ** s)
    H0, ops, coeffs, dts, psi0 = arrays
    st_ref, U_ref = forward_scan_pallas_smalld(
        H0, ops, coeffs, dts, jnp.asarray(psi0), n_squarings=s,
        with_propagators=True, interpret=True,
    )
    st, U = forward_scan_smalld_plain(*_t(*arrays), s, with_propagators=True)
    assert st.shape == (N_T + 1, K, d) and U.shape == (N_T, K, d, d)
    assert st.dtype == U.dtype == torch.complex64
    assert np.abs(st.numpy() - np.asarray(st_ref)).max() < 2e-5
    assert np.abs(U.numpy() - np.asarray(U_ref)).max() < 2e-5
    # without the stream: the states alone, bit-identical
    st_only = forward_scan_smalld_plain(*_t(*arrays), s)
    assert torch.equal(st_only, st)
    # on CPU tensors the wrapper IS the plain version, and counts nothing
    before = dict(hopper_prop.launches)
    st_w, U_w = forward_scan_smalld(*_t(*arrays), s, with_propagators=True)
    assert torch.equal(st_w, st) and torch.equal(U_w, U)
    assert torch.equal(forward_scan_smalld(*_t(*arrays), s), st)
    assert hopper_prop.launches == before


def test_forward_scan_smalld_is_the_per_trajectory_scan_at_small_d():
    """The function is that of ``forward_scan_pertraj``: the plain versions
    agree bit for bit, and the unitary propagators keep the norms."""
    arrays = _t(*_inputs(3, 20, seed=7, hscale=1.0))
    st, U = forward_scan_smalld_plain(*arrays, 1, with_propagators=True)
    st_k, U_k = forward_scan_pertraj_plain(*arrays, 1)
    assert torch.equal(st, st_k) and torch.equal(U, U_k)
    norms = torch.linalg.vector_norm(st, dim=-1)
    assert float((norms - 1).abs().max()) < 1e-5
    with pytest.raises(ValueError, match="one generator per trajectory"):
        forward_scan_smalld_plain(arrays[0][:5], *arrays[1:], 1)
    with pytest.raises(ValueError, match=r"\(N_T, T\)"):
        forward_scan_smalld_plain(
            arrays[0], arrays[1], arrays[2][None].repeat(20, 1, 1),
            arrays[3], arrays[4], 1)


@pytest.mark.parametrize("prefactor", [1.0, 0.05, 30.0])
@pytest.mark.parametrize("tolerance", [1e-16, 1e-9, 1e-8])
def test_taylor_order_for_bound_matches_reference(tolerance, prefactor):
    for bound in (0.0, 1e-6, 0.003, 0.1, 0.5, 1.0, 2.0, 7.5, 30.0, 200.0):
        for max_order in (2, 10, 100):
            got = taylor_order_for_bound(bound, tolerance=tolerance,
                                         max_order=max_order,
                                         prefactor=prefactor)
            want = ref_taylor_order_for_bound(bound, tolerance=tolerance,
                                              max_order=max_order,
                                              prefactor=prefactor)
            assert got == want, (bound, max_order)
    # defaults, and the None case: no order within max_order
    assert taylor_order_for_bound(0.1) == ref_taylor_order_for_bound(0.1)
    assert taylor_order_for_bound(50.0, tolerance=1e-16, max_order=20) is None
    assert taylor_order_for_bound(1.0, tolerance=1e-9, max_order=2) is None


# name -> (n_samples, d, dtype, routed to the small-dimension kernel?)
GATE_CASES = {
    "qutrits_130_c64": (130, 3, np.complex64, True),
    "qutrits_127_c64": (127, 3, np.complex64, False),   # K < 128
    "qutrits_130_c128": (130, 3, np.complex128, False),  # not the kernels'
    "d5_130_c64": (130, 5, np.complex64, False),         # d > 4
    "qubits_128_c64": (128, 2, np.complex64, True),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_smalld_gate_routes_as_the_reference_does(case):
    n, d, dtype, expected = GATE_CASES[case]
    tlist = np.linspace(0, 2.0, 5)
    cp_ref = ref_compile_problem(
        ref_transmon_ensemble(n, d=d, T=2.0), tlist, J_T=ref_J_T_sm,
        dtype=dtype, use_pallas=True,
    )
    cp = gt.compile_problem(
        transmon_ensemble_trajectories(n, d=d, T=2.0), tlist, J_T=J_T_sm,
        dtype=dtype, device="cpu",
    )
    assert ref_fg_mod._pallas_smalld_enabled(cp_ref, None) == expected
    assert port_fg._smalld_enabled(cp) == expected
    consts = port_fg._device_constants(cp, torch.device("cpu"))
    assert consts["smalld"] == expected and consts["gs"] == 1
    assert consts["H0"].shape[0] == n
    for key in ("psi0", "H0", "ops", "M", "Mfix"):
        assert np.array_equal(getattr(cp, key), getattr(cp_ref, key)), key


def test_smalld_gate_sees_shared_and_per_trajectory_tables():
    """A shared generator and per-trajectory coefficient tables stay off
    the small-dimension route, whatever K and d."""
    sx = np.array([[0, 1], [1, 0]], dtype=complex)
    sz = np.array([[1, 0], [0, -1]], dtype=complex)

    def eps(t):
        return 0.1

    H = gt.hamiltonian(0.5 * sz, (sx, eps))
    tlist = np.linspace(0, 1.0, 4)
    shared = [gt.Trajectory([1, 0], H, target_state=[0, 1])
              for _ in range(128)]
    cp = gt.compile_problem(shared, tlist, J_T=J_T_sm, device="cpu",
                            dtype=np.complex64)
    assert cp.shared_generator and not port_fg._smalld_enabled(cp)
    shaped = [
        gt.Trajectory([1, 0], gt.hamiltonian(
            (0.5 + 0.001 * k) * sz,
            (sx, gt.ShapedAmplitude(eps, lambda t, k=k: 1.0 + 0.001 * k))),
            target_state=[0, 1])
        for k in range(128)
    ]
    cp = gt.compile_problem(shaped, tlist, J_T=J_T_sm, device="cpu",
                            dtype=np.complex64)
    assert cp.per_traj_coeffs and not port_fg._smalld_enabled(cp)
    J, g, aux = build_fg(cp)(cp.guess_pulsevals.reshape(-1))
    assert np.isfinite(float(J)) and bool(torch.isfinite(g).all())


@pytest.mark.parametrize("method", ["gradgen", "taylor"])
def test_smalld_ensemble_fg_complex64_matches_reference_kernels(method):
    """K = 130 qutrits through ``build_fg`` and ``build_f`` in complex64:
    the reference with its Pallas kernels in interpret mode (the
    small-dimension forward kernel under either gradient method)."""
    trajs = ref_transmon_ensemble(130, d=3, T=4.0)
    tlist = np.linspace(0, 4.0, 9)
    cp_ref = ref_compile_problem(
        trajs, tlist, J_T=ref_J_T_sm, dtype=np.complex64,
        gradient_method=method, use_pallas=True,
    )
    assert ref_fg_mod._pallas_smalld_enabled(cp_ref, None)
    cp = compiled_problem_from_numpy(
        _arrays_of(cp_ref), device="cpu", J_T="J_T_sm",
        gradient_method=method,
    )
    assert port_fg._smalld_enabled(cp)
    x = _pulses(cp_ref)["perturbed"]
    J_ref, g_ref, _ = ref_build_fg(cp_ref)(x)
    J, g, aux = build_fg(cp)(x)
    g, g_ref = g.numpy(), np.asarray(g_ref)
    assert abs(float(J) - float(J_ref)) < 1e-5 * max(1.0, abs(float(J_ref)))
    assert np.max(np.abs(g - g_ref)) < 2e-3 * np.max(np.abs(g_ref))
    assert bool(aux["taylor_ok"]) and bool(aux["chi_ok"])
    Jf_ref, _ = ref_build_f(cp_ref)(x)
    Jf, auxf = build_f(cp)(x)
    assert abs(float(Jf) - float(Jf_ref)) < 1e-5
    assert float(Jf) == float(J) and torch.equal(auxf["psi_T"], aux["psi_T"])


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """The wrapper's checks are plain Python and run before any launch; on
    a CUDA tensor they raise instead of falling back (here: the shapes the
    checks see, on the CPU path's own validation helpers)."""
    from grape_tpu_torch.ops.hopper_prop import (
        SMALLD_MAX_DIM, _check_group_args,
    )

    assert SMALLD_MAX_DIM == 4
    H0, ops, co, dts, psi0 = _t(*_inputs(3, 5, seed=1, hscale=1.0))
    assert _check_group_args(H0, ops, co, dts) == (5, T, 3, N_T, 0)
    with pytest.raises(ValueError, match="complex64"):
        _check_group_args(H0.to(torch.complex128), ops, co, dts)
    with pytest.raises(ValueError, match="shape"):
        _check_group_args(H0, ops[:, :1].contiguous(), co, dts)


def test_kernel_source_is_part_of_the_build():
    """The build takes every ``.cu`` under ``csrc``: the small-dimension
    kernel's source is among them, and declares the two entry points the
    wrapper calls."""
    import os

    from grape_tpu_torch.ops._build import kernel_sources

    cu, _ = kernel_sources()
    names = [os.path.basename(f) for f in cu]
    assert "smalld_scan.cu" in names and "prop_scan.cu" in names
    with open(cu[names.index("smalld_scan.cu")]) as f:
        src = f.read()
    for entry in ("grape_smalld_propagators", "grape_smalld_apply"):
        assert f"int {entry}(" in src


# ---- the fused kernel's launch plan (hopper_prop.smalld_route) ------------

SMALLD_PLANS = [
    # (d, K, N_T): (tile, window, ctas, smem) on 132 SMs
    # the qutrit ensemble (kernel_check_smalld, smalld_routes)
    ((3, 1024, 400), (8, 32, 128, 36864)),
    # kernel_check_smalld's ragged shapes
    ((2, 128, 1), (1, 1, 128, 80)),
    ((3, 129, 7), (1, 7, 129, 1008)),
    ((4, 1000, 33), (8, 32, 125, 69632)),
    ((4, 4096, 20), (32, 8, 128, 69632)),
    ((2, 4096, 1), (32, 1, 128, 2560)),
    ((3, 1000, 1), (8, 1, 125, 1152)),
    ((4, 129, 50), (1, 50, 129, 13600)),
    # smalld_routes
    ((2, 128, 400), (1, 64, 128, 5120)),
    ((3, 130, 400), (1, 64, 130, 9216)),
    ((4, 1000, 400), (8, 32, 125, 69632)),
    ((4, 4096, 100), (32, 8, 128, 69632)),
    # kernel_check_time's small-d shape (forward_scan_time, K >= 128)
    ((3, 256, 50), (2, 50, 128, 14400)),
    # past one wave at the largest tile: more CTAs than SMs
    ((3, 8192, 400), (32, 8, 256, 36864)),
]


@pytest.mark.parametrize("shape,plan", SMALLD_PLANS,
                         ids=[f"d{d}-K{K}-N{n}" for (d, K, n), _ in
                              SMALLD_PLANS])
def test_smalld_route(shape, plan):
    got = hopper_prop.smalld_route(*shape, 132)
    assert got["route"] == "fused"
    assert (got["tile"], got["window"], got["ctas"], got["smem"]) == plan


def test_smalld_route_invariants():
    """The tile is the smallest power of two up to 32 whose CTAs fit one
    wave; one propagator item per producer thread a window (window · tile
    ≤ 256, at most 64 steps and N_T); two buffers at an odd pitch of
    d² | 1 float2 within one CTA's shared memory."""
    rng = np.random.default_rng(5)
    for _ in range(300):
        d = int(rng.integers(1, 5))
        K = int(rng.integers(1, 20000))
        n = int(rng.integers(1, 2000))
        sms = int(rng.choice([66, 114, 132]))
        p = hopper_prop.smalld_route(d, K, n, sms)
        tile = p["tile"]
        assert tile in (1, 2, 4, 8, 16, 32)
        assert p["ctas"] == -(-K // tile)
        assert p["ctas"] <= sms or tile == 32
        assert tile == 1 or -(-K // (tile // 2)) > sms
        assert 1 <= p["window"] <= min(64, n)
        assert p["window"] * tile <= 256
        assert p["window"] == min(n, 64, 256 // tile)
        pitch = (d * d) | 1
        assert pitch % 2 == 1
        assert p["smem"] == 2 * p["window"] * tile * pitch * 8 <= 232448


def test_forced_smalld_route_restores():
    assert hopper_prop._forced_smalld == {"route": None}
    with hopper_prop._forced_smalld_route("pair"):
        assert hopper_prop._forced_smalld == {"route": "pair"}
    assert hopper_prop._forced_smalld == {"route": None}


def test_fused_kernel_source_is_part_of_the_build():
    """The fused kernel's source is built with the others, declares the
    entry point the wrapper calls, and shares the propagator arithmetic
    with the two-launch pair through one header."""
    import os

    from grape_tpu_torch.ops._build import kernel_sources

    cu, hdr = kernel_sources()
    names = [os.path.basename(f) for f in cu]
    assert "smalld_fused.cu" in names
    assert "smalld_expm.cuh" in [os.path.basename(f) for f in hdr]
    for name in ("smalld_fused.cu", "smalld_scan.cu"):
        with open(cu[names.index(name)]) as f:
            src = f.read()
        assert '#include "smalld_expm.cuh"' in src
        assert "smalld_propagator<D>(" in src
    with open(cu[names.index("smalld_fused.cu")]) as f:
        assert "int grape_smalld_fused(" in f.read()
