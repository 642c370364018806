"""The plain PyTorch versions of the three main-path kernels against the
Pallas kernels they replace, run in interpret mode on the CPU, on the same
seeded inputs; the Fréchet traces by both of their algorithms (dense and
rank-factored) against the same interpret-mode result.

The plain version repeats the CUDA kernel's arithmetic (degree-16 Taylor,
static ``s``, pair doublings) and is what ``chip_smoke.py`` holds the CUDA
kernel against on the card.  Tolerances (float32 arithmetic on both sides):
storage, U and chis to 2e-5 absolute on unit-norm states; trj to 2e-5 of
its scale."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from grape_tpu.ops.pallas_frechet import frechet_trace_pallas_shared
from grape_tpu.ops.pallas_prop import (
    chi_scan_pallas_shared, forward_scan_pallas_shared,
)
from grape_tpu_torch.ops.hopper_frechet import (
    frechet_trace_shared, frechet_trace_shared_plain,
)
from grape_tpu_torch.ops.hopper_prop import (
    chi_scan_shared, chi_scan_shared_plain, forward_scan_shared,
    forward_scan_shared_plain,
)

torch.set_num_threads(1)

N_T, T = 12, 2


def _inputs(d, K, seed, hscale):
    rng = np.random.default_rng(seed)
    H0 = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    H0 = hscale * (H0 + H0.conj().T) / np.sqrt(d)
    ops = rng.normal(size=(T, d, d)) + 1j * rng.normal(size=(T, d, d))
    ops = (ops + np.conj(np.swapaxes(ops, -1, -2))) / np.sqrt(d)
    coeffs = (0.3 * rng.normal(size=(N_T, T))).astype(np.float32)
    dts = (0.1 * (1 + 0.2 * rng.uniform(size=N_T))).astype(np.float32)
    psi0 = rng.normal(size=(K, d)) + 1j * rng.normal(size=(K, d))
    psi0 /= np.linalg.norm(psi0, axis=1, keepdims=True)
    chi0 = rng.normal(size=(K, d)) + 1j * rng.normal(size=(K, d))
    chi0 /= np.linalg.norm(chi0, axis=1, keepdims=True)
    c64 = np.complex64
    return (H0.astype(c64), ops.astype(c64), coeffs, dts, psi0.astype(c64),
            chi0.astype(c64))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


CASES = [
    # (d, K, n_squarings, hscale): hscale keeps |dt| ||H|| 2^-s <= 2
    (8, 1, 0, 1.0), (8, 3, 0, 1.0), (16, 3, 0, 1.0),
    (8, 3, 2, 4.0), (16, 1, 2, 4.0), (16, 3, 2, 4.0),
    (8, 11, 2, 4.0),  # K > 8: no K-blocking artefact of the TPU kernel
    # s = 1 with |dt| ||H|| in (2, 4], where the problems take s = 1: the
    # factored algorithm's Krylov extension against the TPU kernel
    (8, 3, 1, 4.0), (16, 3, 1, 2.0),
]


@pytest.mark.parametrize("d,K,s,hscale", CASES)
def test_forward_scan_plain_matches_pallas(d, K, s, hscale):
    H0, ops, coeffs, dts, psi0, _ = _inputs(d, K, 7 * d + K, hscale)
    st_ref, U_ref = forward_scan_pallas_shared(
        jnp.asarray(H0), jnp.asarray(ops), coeffs, dts, jnp.asarray(psi0),
        n_squarings=s, with_propagators=True, interpret=True,
    )
    st, U = forward_scan_shared_plain(
        *_t(H0, ops, coeffs, dts, psi0), n_squarings=s
    )
    assert tuple(st.shape) == (N_T + 1, K, d) and tuple(U.shape) == (N_T, d, d)
    assert st.dtype == torch.complex64 and U.dtype == torch.complex64
    assert np.max(np.abs(U.numpy() - np.asarray(U_ref))) < 2e-5
    assert np.max(np.abs(st.numpy() - np.asarray(st_ref))) < 2e-5
    # the propagators are unitary to float32 accuracy
    eye = np.eye(d)
    unit = U.numpy() @ np.conj(np.swapaxes(U.numpy(), -1, -2))
    assert np.max(np.abs(unit - eye)) < 1e-5


@pytest.mark.parametrize("d,K,s,hscale", CASES)
def test_chi_scan_plain_matches_pallas(d, K, s, hscale):
    H0, ops, coeffs, dts, psi0, chi0 = _inputs(d, K, 11 * d + K, hscale)
    _, U = forward_scan_shared_plain(
        *_t(H0, ops, coeffs, dts, psi0), n_squarings=s
    )
    chis_ref = chi_scan_pallas_shared(
        jnp.asarray(U.numpy()), jnp.asarray(chi0), interpret=True
    )
    chis = chi_scan_shared_plain(U, torch.from_numpy(chi0))
    assert tuple(chis.shape) == (N_T, K, d)
    assert np.max(np.abs(chis.numpy() - np.asarray(chis_ref))) < 2e-5
    # chis[n] is chi BEFORE the step-n update: the last entry is chi_hat
    assert np.array_equal(chis[-1].numpy(), chi0)


@pytest.mark.parametrize("d,K,s,hscale", CASES)
def test_frechet_trace_plain_matches_pallas(d, K, s, hscale, monkeypatch):
    from grape_tpu_torch.ops import hopper_frechet

    # several chunks, the last one ragged, at this small N_T
    monkeypatch.setattr(hopper_frechet, "_PLAIN_CHUNK", 5)
    H0, ops, coeffs, dts, psi0, chi0 = _inputs(d, K, 13 * d + K, hscale)
    rng = np.random.default_rng(d + K + s)
    psis = (rng.normal(size=(N_T, K, d))
            + 1j * rng.normal(size=(N_T, K, d))).astype(np.complex64)
    chis = (rng.normal(size=(N_T, K, d))
            + 1j * rng.normal(size=(N_T, K, d))).astype(np.complex64)
    trj_ref = np.asarray(frechet_trace_pallas_shared(
        jnp.asarray(H0), jnp.asarray(ops), coeffs, dts, jnp.asarray(psis),
        jnp.asarray(chis), n_squarings=s, interpret=True,
        precision="highest",
    ))
    scale = max(np.max(np.abs(trj_ref)), 1.0)
    H0_t, ops_t, coeffs_t, dts_t, psis_t, chis_t = _t(
        H0, ops, coeffs, dts, psis, chis)
    assert torch.equal(
        frechet_trace_shared_plain(H0_t, ops_t, coeffs_t, dts_t, psis_t,
                                   chis_t, n_squarings=s),
        hopper_frechet._PLAIN[hopper_frechet.frechet_route(d, T, K, s)](
            H0_t[None], ops_t[None], coeffs_t, dts_t, psis_t, chis_t, s))
    # both algorithms against the same interpret-mode result
    for route, plain in hopper_frechet._PLAIN.items():
        trj = plain(H0_t[None], ops_t[None], coeffs_t, dts_t, psis_t,
                    chis_t, s).numpy()
        assert trj.shape == (N_T, K, T)
        assert np.max(np.abs(trj - trj_ref)) < 2e-5 * scale, route


def test_wrappers_take_the_plain_version_for_cpu_tensors():
    """On CPU tensors the wrappers run the plain versions (and count no
    kernel launch); the result is the plain version's, bit for bit."""
    from grape_tpu_torch.ops import hopper_frechet, hopper_prop

    H0, ops, coeffs, dts, psi0, chi0 = _t(*_inputs(8, 3, 1, 1.0))
    before = (dict(hopper_prop.launches), dict(hopper_frechet.launches))
    st, U = forward_scan_shared(H0, ops, coeffs, dts, psi0, 1)
    st_p, U_p = forward_scan_shared_plain(H0, ops, coeffs, dts, psi0, 1)
    assert torch.equal(st, st_p) and torch.equal(U, U_p)
    chis = chi_scan_shared(U, chi0)
    assert torch.equal(chis, chi_scan_shared_plain(U, chi0))
    psis = st[:-1].contiguous()
    trj = frechet_trace_shared(H0, ops, coeffs, dts, psis, chis, 1)
    assert torch.equal(
        trj, frechet_trace_shared_plain(H0, ops, coeffs, dts, psis, chis, 1)
    )
    assert before == (hopper_prop.launches, hopper_frechet.launches)


def test_frechet_precision_names():
    H0, ops, coeffs, dts, psi0, chi0 = _t(*_inputs(8, 1, 2, 1.0))
    st, U = forward_scan_shared(H0, ops, coeffs, dts, psi0, 0)
    chis = chi_scan_shared(U, chi0)
    args = (H0, ops, coeffs, dts, st[:-1].contiguous(), chis, 0)
    a = frechet_trace_shared(*args, precision="highest")
    b = frechet_trace_shared(*args, precision="high")
    assert torch.equal(a, b)  # both names mean full float32 here
    with pytest.raises(ValueError, match="precision"):
        frechet_trace_shared(*args, precision="default")
