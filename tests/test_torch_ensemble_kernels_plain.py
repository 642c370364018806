"""The plain PyTorch versions of the ensemble kernels (grouped and
per-trajectory forward scan, per-trajectory Fréchet trace, grouped χ chain)
against the Pallas kernels they replace, run in interpret mode on the CPU,
on the same seeded inputs.

The trajectories come in G groups of gs contiguous ones that share a
generator.  Tolerances (float32 arithmetic on both sides): storage, U and
chis to 2e-5 absolute on unit-norm states; trj to 2e-5 of its scale."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from grape_tpu.ops.pallas_frechet import frechet_trace_pallas_pertraj
from grape_tpu.ops.pallas_prop import (
    chi_scan_pallas_shared, forward_scan_pallas, forward_scan_pallas_grouped,
    forward_scan_pallas_shared,
)
from grape_tpu_torch.ops import hopper_frechet, hopper_prop
from grape_tpu_torch.ops.hopper_frechet import (
    frechet_trace_pertraj, frechet_trace_pertraj_plain,
    frechet_trace_shared_plain,
)
from grape_tpu_torch.ops.hopper_prop import (
    chi_scan_grouped, chi_scan_grouped_plain, chi_scan_recompute,
    chi_scan_recompute_plain, forward_scan_grouped,
    forward_scan_grouped_plain, forward_scan_pertraj,
    forward_scan_pertraj_plain, forward_scan_shared_plain,
)

torch.set_num_threads(1)

D, N_T, T = 8, 6, 2
C64 = np.complex64


def _inputs(G, gs, seed, s, per_group_coeffs=False, d=D):
    """Seeded grouped inputs; the drift scale keeps |dt| ||H|| 2^-s <= 2
    (at s = 1 with |dt| ||H|| between 3.1 and 3.6 at d = 8, where s = 1 is
    the squaring count the problems take)."""
    rng = np.random.default_rng(seed)
    K = G * gs
    hscale = 4.0 if s else 1.0
    H0 = rng.normal(size=(G, d, d)) + 1j * rng.normal(size=(G, d, d))
    H0 = hscale * (H0 + np.conj(np.swapaxes(H0, -1, -2))) / np.sqrt(d)
    ops = rng.normal(size=(G, T, d, d)) + 1j * rng.normal(size=(G, T, d, d))
    ops = (ops + np.conj(np.swapaxes(ops, -1, -2))) / np.sqrt(d)
    shape = (G, N_T, T) if per_group_coeffs else (N_T, T)
    coeffs = (0.3 * rng.normal(size=shape)).astype(np.float32)
    dts = (0.1 * (1 + 0.2 * rng.uniform(size=N_T))).astype(np.float32)

    def unit():
        v = rng.normal(size=(K, d)) + 1j * rng.normal(size=(K, d))
        return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(C64)

    return H0.astype(C64), ops.astype(C64), coeffs, dts, unit(), unit()


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


@pytest.mark.parametrize("s", [0, 2])
@pytest.mark.parametrize("G,gs", [(2, 3), (2, 4), (1, 5)])
def test_forward_scan_grouped_plain_matches_pallas(G, gs, s):
    H0, ops, coeffs, dts, psi0, _ = _inputs(G, gs, 100 + 7 * gs + s, s)
    st_ref, U_ref = forward_scan_pallas_grouped(
        jnp.asarray(H0), jnp.asarray(ops), coeffs, dts, jnp.asarray(psi0),
        group_size=gs, n_squarings=s, with_propagators=True, interpret=True,
    )
    st, U = forward_scan_grouped_plain(
        *_t(H0, ops, coeffs, dts, psi0), gs, s
    )
    assert tuple(st.shape) == (N_T + 1, G * gs, D)
    assert tuple(U.shape) == (N_T, G, D, D)
    assert st.dtype == torch.complex64 and U.dtype == torch.complex64
    assert _err(U.numpy(), U_ref) < 2e-5
    assert _err(st.numpy(), st_ref) < 2e-5


@pytest.mark.parametrize("s", [0, 2])
def test_forward_scan_pertraj_plain_matches_pallas(s):
    K = 3
    H0, ops, coeffs, dts, psi0, _ = _inputs(K, 1, 200 + s, s)
    st_ref, U_ref = forward_scan_pallas(
        jnp.asarray(H0), jnp.asarray(ops), coeffs, dts, jnp.asarray(psi0),
        n_squarings=s, with_propagators=True, interpret=True,
    )
    st, U = forward_scan_pertraj_plain(*_t(H0, ops, coeffs, dts, psi0), s)
    assert tuple(U.shape) == (N_T, K, D, D)
    assert _err(U.numpy(), U_ref) < 2e-5
    assert _err(st.numpy(), st_ref) < 2e-5
    # without the stream: the same states, no propagators
    st2, U2 = forward_scan_pertraj_plain(
        *_t(H0, ops, coeffs, dts, psi0), s, with_propagators=False
    )
    assert U2 is None and torch.equal(st2, st)


@pytest.mark.parametrize("G,gs", [(3, 1), (2, 3)])
def test_forward_scan_per_group_coefficients(G, gs):
    """One coefficient table per group, which the TPU forward kernels do not
    take: each group must equal the shared-generator Pallas kernel run on
    that group's operators, table and states."""
    s = 2
    H0, ops, coeffs, dts, psi0, _ = _inputs(G, gs, 300 + G, s, True)
    st, U = forward_scan_grouped_plain(
        *_t(H0, ops, coeffs, dts, psi0), gs, s
    )
    for g in range(G):
        ks = slice(g * gs, (g + 1) * gs)
        st_ref, U_ref = forward_scan_pallas_shared(
            jnp.asarray(H0[g]), jnp.asarray(ops[g]), coeffs[g], dts,
            jnp.asarray(psi0[ks]), n_squarings=s, with_propagators=True,
            interpret=True,
        )
        assert _err(U[:, g].numpy(), U_ref) < 2e-5, g
        assert _err(st[:, ks].numpy(), st_ref) < 2e-5, g


@pytest.mark.parametrize("G,gs", [(3, 1), (2, 3), (2, 4)])
def test_chi_scan_grouped_plain_matches_pallas(G, gs):
    """The reference runs the grouped chain as a scan of small products;
    per group it is the shared chain, which has a Pallas kernel."""
    H0, ops, coeffs, dts, psi0, chi0 = _inputs(G, gs, 400 + gs, 0)
    _, U = forward_scan_grouped_plain(*_t(H0, ops, coeffs, dts, psi0), gs, 0)
    chis = chi_scan_grouped_plain(U, torch.from_numpy(chi0))
    assert tuple(chis.shape) == (N_T, G * gs, D)
    for g in range(G):
        ks = slice(g * gs, (g + 1) * gs)
        ref = chi_scan_pallas_shared(
            jnp.asarray(U[:, g].numpy()), jnp.asarray(chi0[ks]),
            interpret=True,
        )
        assert _err(chis[:, ks].numpy(), ref) < 2e-5, g
    # chis[n] is chi BEFORE the step-n update: the last entry is chi_hat
    assert np.array_equal(chis[-1].numpy(), chi0)


@pytest.mark.parametrize("per_group_coeffs", [False, True],
                         ids=["shared_table", "table_per_group"])
@pytest.mark.parametrize("s", [0, 1, 2])
@pytest.mark.parametrize("G,gs", [(3, 1), (2, 3), (2, 4)])
def test_frechet_trace_pertraj_plain_matches_pallas(G, gs, s,
                                                    per_group_coeffs,
                                                    monkeypatch):
    # several chunks, the last one ragged, at this small N_T
    monkeypatch.setattr(hopper_frechet, "_PLAIN_CHUNK", 4 * G * gs)
    H0, ops, coeffs, dts, _, _ = _inputs(
        G, gs, 500 + 11 * gs + s, s, per_group_coeffs
    )
    K = G * gs
    rng = np.random.default_rng(gs + s)
    psis = (rng.normal(size=(N_T, K, D))
            + 1j * rng.normal(size=(N_T, K, D))).astype(C64)
    chis = (rng.normal(size=(N_T, K, D))
            + 1j * rng.normal(size=(N_T, K, D))).astype(C64)
    ref = np.asarray(frechet_trace_pallas_pertraj(
        jnp.asarray(H0), jnp.asarray(ops), coeffs, dts, jnp.asarray(psis),
        jnp.asarray(chis), n_squarings=s, interpret=True,
        precision="highest", group_size=gs,
    ))
    args = _t(H0, ops, coeffs, dts, psis, chis)
    assert torch.equal(
        frechet_trace_pertraj_plain(*args, s, group_size=gs),
        hopper_frechet._PLAIN[hopper_frechet.frechet_route(D, T, gs, s)](
            *args, s))
    # both algorithms against the same interpret-mode result
    for route, plain in hopper_frechet._PLAIN.items():
        trj = plain(*args, s).numpy()
        assert trj.shape == (N_T, K, T)
        assert _err(trj, ref) < 2e-5 * max(np.max(np.abs(ref)), 1.0), route


@pytest.mark.parametrize("per_group_coeffs", [False, True],
                         ids=["shared_table", "table_per_group"])
@pytest.mark.parametrize("gs", [1, 4])
@pytest.mark.parametrize("s", [0, 1, 2, 3])
def test_frechet_factored_equals_dense_complex128(s, gs, per_group_coeffs):
    """The rank-factored algorithm (Krylov sets, fold, extension by E) is
    the dense one rearranged: in complex128 the two agree to 1e-12 of the
    traces' scale, also after the doublings, where the pairing of E^p with
    E^(2^s-1-p) and E being the polynomial, not the exponential, matter."""
    G, d = 2, 10
    H0, ops, coeffs, dts, psis, chis = _inputs(
        G, gs, 1000 + 10 * s + gs, s, per_group_coeffs, d=d)
    rng = np.random.default_rng(s + gs)
    K = G * gs
    psis = rng.normal(size=(N_T, K, d)) + 1j * rng.normal(size=(N_T, K, d))
    chis = rng.normal(size=(N_T, K, d)) + 1j * rng.normal(size=(N_T, K, d))
    args = [x.to(torch.complex128) if x.is_complex() else x.double()
            for x in _t(H0, ops, coeffs, dts)] + _t(psis, chis)
    dense = hopper_frechet._frechet_trace_plain(*args, s)
    fact = hopper_frechet._frechet_trace_factored_plain(*args, s)
    assert fact.dtype == torch.complex128
    assert _err(fact, dense) < 1e-12 * float(dense.abs().max())


def test_frechet_route_by_operation_count():
    """The route is the algorithm with fewer operations for (d, T, gs, s):
    the qutrits (d = 3) dense, the CZ and its ensemble (d = 100) factored
    at s = 0 up to s = 5, dense from the rank 16·2^6 on; the CPU wrapper
    runs the chosen route's plain version and launches nothing."""
    route = hopper_frechet.frechet_route
    assert route(3, 2, 2, 0) == "dense"
    assert route(3, 4, 4, 0) == "dense"
    for gs in (1, 4):
        assert [route(100, 4, gs, s) for s in range(8)] == (
            ["factored"] * 6 + ["dense"] * 2)
    f = hopper_frechet.frechet_flops(100, 4, 4, 0)
    assert f["dense"] > 10 * f["factored"]
    G, gs, s = 2, 3, 0
    H0, ops, coeffs, dts, psi0, chi0 = _t(*_inputs(G, gs, 1100, s))
    psis = psi0[None].repeat(N_T, 1, 1)
    chis = chi0[None].repeat(N_T, 1, 1)
    before = dict(hopper_frechet.launches)
    trj = frechet_trace_pertraj(H0, ops, coeffs, dts, psis, chis, s,
                                group_size=gs)
    assert route(D, T, gs, s) == "factored"
    assert torch.equal(trj, hopper_frechet._frechet_trace_factored_plain(
        H0, ops, coeffs, dts, psis, chis, s))
    assert before == hopper_frechet.launches


def _extension_error_at(step_norm):
    """The float32 factored plain traces at d = 100, s = 1, with the
    largest dt·‖H_n‖₁ scaled to ``step_norm``, against the complex128 dense
    traces: ``(error, scale)``."""
    G, gs, d, s = 2, 2, 100, 1
    H0, ops, coeffs, dts, _, _ = _inputs(G, gs, 1200, s, d=d)
    H = H0[None] + np.einsum("nt,gtij->ngij", coeffs, ops)
    norm = np.max(dts[:, None] * np.abs(H).sum(axis=-2).max(axis=-1))
    H0 = (H0 * (step_norm / norm)).astype(C64)
    ops = (ops * (step_norm / norm)).astype(C64)
    H = H0[None] + np.einsum("nt,gtij->ngij", coeffs, ops)
    step = dts[:, None] * np.abs(H).sum(axis=-2).max(axis=-1)
    assert step_norm - 0.1 < step.max() <= step_norm + 1e-5
    rng = np.random.default_rng(1201)
    K = G * gs
    psis = (rng.normal(size=(N_T, K, d))
            + 1j * rng.normal(size=(N_T, K, d))) / np.sqrt(2 * d)
    chis = (rng.normal(size=(N_T, K, d))
            + 1j * rng.normal(size=(N_T, K, d))) / np.sqrt(2 * d)
    args = _t(H0, ops, coeffs, dts, psis.astype(C64), chis.astype(C64))
    before = hopper_frechet.krylov_extension_calls
    trj = hopper_frechet._frechet_trace("frechet_trace_pertraj", *args, s,
                                        route="factored")
    assert hopper_frechet.krylov_extension_calls == before + 1
    assert trj.dtype == torch.complex64
    args128 = [x.to(torch.complex128) if x.is_complex() else x.double()
               for x in args[:4]] + _t(psis, chis)
    ref = hopper_frechet._frechet_trace_plain(*args128, s)
    return _err(trj, ref), max(float(ref.abs().max()), 1.0)


def test_krylov_extension_float32_at_the_cells_norm():
    """At s = 1 the factored algorithm carries both Krylov sets on to
    degree 31 and folds them into the doubling's blocks instead of forming
    E.  In float32 at d = 100 with dt·‖H_n‖₁ up to 2 (‖A/2‖₁ near 1, where
    the benchmark's CZ and ensemble cells run) its traces stay within the
    plain versions' float32 tolerance of the complex128 dense traces."""
    err, scale = _extension_error_at(2.0)
    assert err < 2e-5 * scale


def test_krylov_extension_float32_at_the_top_of_its_range():
    """s = 1 is taken up to dt·‖H_n‖₁ = 4, where ‖A/2‖₁ reaches 2 and the
    degree-31 Krylov vectors grow as 2^j: just under 4 the float32 traces
    of the extension stay within the same tolerance of complex128 dense."""
    err, scale = _extension_error_at(3.99)
    assert err < 2e-5 * scale


def test_krylov_extension_counter_and_operation_count():
    """An s = 1 call on the CPU path takes the Krylov extension and counts
    it, an s = 0 call does not; at s = 1 the factored operation count holds
    no d³ term (its third difference in d is zero, as it is not at s = 2),
    and it is the count ``chip_smoke.py`` holds the kernel's time against."""
    import importlib.util
    import os

    G, gs, d = 2, 3, 16
    assert hopper_frechet.frechet_route(d, T, gs, 1) == "factored"
    calls = hopper_frechet.krylov_extension_calls
    launches = dict(hopper_frechet.launches)
    for s, taken in ((1, 1), (0, 0), (2, 0)):
        H0, ops, coeffs, dts, psi0, chi0 = _t(
            *_inputs(G, gs, 1300 + s, s, d=d))
        psis = psi0[None].repeat(N_T, 1, 1)
        chis = chi0[None].repeat(N_T, 1, 1)
        frechet_trace_pertraj(H0, ops, coeffs, dts, psis, chis, s,
                              group_size=gs)
        assert hopper_frechet.krylov_extension_calls == calls + taken
        calls = hopper_frechet.krylov_extension_calls
    assert launches == hopper_frechet.launches

    def factored(d_, s_):
        return hopper_frechet.frechet_flops(d_, 4, 4, s_)["factored"]

    def third_difference(s_):
        return (factored(103, s_) - 3 * factored(102, s_)
                + 3 * factored(101, s_) - factored(100, s_))

    assert third_difference(0) == 0.0 and third_difference(1) == 0.0
    assert third_difference(2) == 6 * 6 * 8.0
    assert factored(100, 1) < factored(100, 2) - 6 * 8.0 * 100 ** 3

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    for s in (0, 1, 2):
        assert chip_smoke.frechet_needed_flops(100, 4, 4, 2000, s) == (
            2000 * factored(100, s))


@pytest.mark.parametrize("steps_per_window", [1, 4])
def test_windows_without_stored_propagators(steps_per_window, monkeypatch):
    """Where the propagator stream is not kept, the forward scan and the χ
    chain form the propagators one window of steps at a time: the same
    states and co-states as with the stream."""
    G, gs, s = 2, 3, 1
    H0, ops, coeffs, dts, psi0, chi0 = _t(*_inputs(G, gs, 600, s))
    st, U = forward_scan_grouped_plain(H0, ops, coeffs, dts, psi0, gs, s)
    chis = chi_scan_grouped_plain(U, chi0)
    monkeypatch.setattr(hopper_prop, "_WINDOW_BYTES",
                        steps_per_window * G * D * D * 8)
    assert hopper_prop._window_steps(G, D, N_T) == steps_per_window
    st_w, U_w = forward_scan_grouped_plain(
        H0, ops, coeffs, dts, psi0, gs, s, with_propagators=False
    )
    assert U_w is None
    assert _err(st_w, st) < 1e-6
    chis_w, chi_out = chi_scan_recompute_plain(H0, ops, coeffs, dts, chi0, s)
    assert _err(chis_w, chis) < 1e-6
    # χ carried out of the first step: one more update of chis[0]
    G_, gs_ = U.shape[1], chi0.shape[0] // U.shape[1]
    chi_first = (chis[0].reshape(G_, gs_, -1) @ U[0].conj()).reshape(
        chi0.shape)
    assert _err(chi_out, chi_first) < 1e-6
    # and the wrapper on CPU tensors is that plain version
    chis_c, chi_out_c = chi_scan_recompute(H0, ops, coeffs, dts, chi0, s)
    assert torch.equal(chis_c, chis_w) and torch.equal(chi_out_c, chi_out)


def test_identical_operators_reduce_to_the_shared_kernels():
    """With every group given the same operators the grouped versions equal
    the shared-generator ones, and the per-trajectory version on operators
    repeated gs times equals the grouped one."""
    G, gs, s = 2, 3, 1
    H0, ops, coeffs, dts, psi0, chi0 = _inputs(1, G * gs, 700, s)
    H0g, opsg = np.repeat(H0, G, axis=0), np.repeat(ops, G, axis=0)
    H0k, opsk = np.repeat(H0, G * gs, axis=0), np.repeat(ops, G * gs, axis=0)
    st_s, U_s = forward_scan_shared_plain(
        *_t(H0[0], ops[0], coeffs, dts, psi0), s
    )
    st_g, U_g = forward_scan_grouped_plain(
        *_t(H0g, opsg, coeffs, dts, psi0), gs, s
    )
    st_k, U_k = forward_scan_pertraj_plain(
        *_t(H0k, opsk, coeffs, dts, psi0), s
    )
    assert _err(st_g, st_s) < 1e-6 and _err(st_k, st_g) < 1e-6
    assert _err(U_g, U_s[:, None].expand_as(U_g)) < 1e-6
    assert _err(U_k.reshape(N_T, G, gs, D, D)[:, :, 0], U_g) < 1e-6
    chis = chi_scan_grouped_plain(U_g, torch.from_numpy(chi0))
    psis = st_g[:-1].contiguous()
    trj_s = frechet_trace_shared_plain(
        *_t(H0[0], ops[0], coeffs, dts), psis, chis, s
    )
    trj_g = frechet_trace_pertraj_plain(
        *_t(H0g, opsg, coeffs, dts), psis, chis, s, group_size=gs
    )
    trj_k = frechet_trace_pertraj_plain(
        *_t(H0k, opsk, coeffs, dts), psis, chis, s
    )
    scale = max(float(trj_s.abs().max()), 1.0)
    assert _err(trj_g, trj_s) < 1e-6 * scale
    assert _err(trj_k, trj_g) < 1e-6 * scale


def test_wrappers_take_the_plain_version_for_cpu_tensors():
    """On CPU tensors the wrappers run the plain versions (and count no
    kernel launch); the result is the plain version's, bit for bit."""
    G, gs, s = 2, 3, 1
    H0, ops, coeffs, dts, psi0, chi0 = _t(*_inputs(G, gs, 800, s))
    before = (dict(hopper_prop.launches), dict(hopper_frechet.launches))
    st, U = forward_scan_grouped(H0, ops, coeffs, dts, psi0, gs, s)
    st_p, U_p = forward_scan_grouped_plain(H0, ops, coeffs, dts, psi0, gs, s)
    assert torch.equal(st, st_p) and torch.equal(U, U_p)
    chis = chi_scan_grouped(U, chi0)
    assert torch.equal(chis, chi_scan_grouped_plain(U, chi0))
    psis = st[:-1].contiguous()
    trj = frechet_trace_pertraj(H0, ops, coeffs, dts, psis, chis, s,
                                group_size=gs)
    assert torch.equal(trj, frechet_trace_pertraj_plain(
        H0, ops, coeffs, dts, psis, chis, s, group_size=gs))
    H0k = H0.repeat_interleave(gs, dim=0)
    opsk = ops.repeat_interleave(gs, dim=0)
    st_k, U_k = forward_scan_pertraj(H0k, opsk, coeffs, dts, psi0, s)
    assert torch.equal(
        st_k, forward_scan_pertraj_plain(H0k, opsk, coeffs, dts, psi0, s)[0]
    )
    assert before == (hopper_prop.launches, hopper_frechet.launches)
    assert set(hopper_prop.launches) == {
        "forward_scan_shared", "chi_scan_shared", "forward_scan_grouped",
        "forward_scan_pertraj", "chi_scan_grouped", "chi_scan_recompute",
        "forward_scan_smalld", "forward_scan_time",
    }
    assert set(hopper_frechet.launches) == {
        "frechet_trace_shared", "frechet_trace_pertraj",
        "frechet_trace_shared_factored", "frechet_trace_pertraj_factored",
    }


def test_group_arguments_are_checked():
    """The shape checks of the grouped wrappers are plain Python."""
    G, gs, s = 2, 3, 0
    H0, ops, coeffs, dts, psi0, chi0 = _t(*_inputs(G, gs, 900, s))
    assert hopper_prop._check_group_args(H0, ops, coeffs, dts) == (
        G, T, D, N_T, 0
    )
    per_group = coeffs[None].repeat(G, 1, 1)
    assert hopper_prop._check_group_args(H0, ops, per_group, dts)[-1] == (
        N_T * T
    )
    with pytest.raises(ValueError, match="shape"):
        hopper_prop._check_group_args(H0, ops, per_group[:1], dts)
    with pytest.raises(ValueError, match="group_size"):
        forward_scan_grouped(H0, ops, coeffs, dts, psi0, gs + 1, s)
    with pytest.raises(ValueError, match="one generator per trajectory"):
        forward_scan_pertraj(H0, ops, coeffs, dts, psi0, s)
    with pytest.raises(ValueError, match="groups"):
        chi_scan_grouped_plain(torch.zeros(N_T, 4, D, D, dtype=chi0.dtype),
                               chi0)
    with pytest.raises(ValueError, match="group_size"):
        frechet_trace_pertraj(H0, ops, coeffs, dts, psi0[None], chi0[None],
                              s, group_size=1)
