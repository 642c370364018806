"""grape_tpu_torch.ops.expm against grape_tpu.ops.expm on the same seeded
matrices (made with numpy and handed to both).

Tolerances: complex128 to 1e-12 relative (both sides run the same Padé-13 /
Taylor arithmetic in double precision; the difference is the order of sums
in the matrix products and the LU solve), complex64 to 2e-6 relative
(float32 rounding of the same arithmetic)."""

import importlib

import numpy as np
import pytest
import torch

# grape_tpu.ops re-exports the function `expm` under the module's name
ref = importlib.import_module("grape_tpu.ops.expm")
port = importlib.import_module("grape_tpu_torch.ops.expm")

torch.set_num_threads(1)

TOL = {np.complex128: 1e-12, np.complex64: 2e-6}


def _matrix(kind, d, seed, norm, batch=()):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=batch + (d, d)) + 1j * rng.normal(size=batch + (d, d))
    if kind == "antiherm":
        A = -0.5j * (A + np.conj(np.swapaxes(A, -1, -2)))
    nrm = np.abs(A).sum(axis=-2).max()
    return A * (norm / nrm)


def _rel(a, b):
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
@pytest.mark.parametrize("d", [4, 16])
@pytest.mark.parametrize("kind", ["antiherm", "general"])
def test_expm_taylor_ps(kind, d, dtype):
    A = _matrix(kind, d, seed=d, norm=1.5, batch=(3,)).astype(dtype)
    want = np.asarray(ref.expm_taylor_ps(A))
    got = port.expm_taylor_ps(torch.from_numpy(A)).numpy()
    assert got.dtype == dtype
    assert _rel(got, want) < TOL[dtype]


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
@pytest.mark.parametrize("d", [4, 16])
@pytest.mark.parametrize("kind", ["antiherm", "general"])
def test_expm_pade13(kind, d, dtype):
    A = _matrix(kind, d, seed=10 + d, norm=1.0, batch=(3,)).astype(dtype)
    want = np.asarray(ref.expm_pade13(A))
    got = port.expm_pade13(torch.from_numpy(A)).numpy()
    assert got.dtype == dtype
    assert _rel(got, want) < TOL[dtype]


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
@pytest.mark.parametrize("d", [4, 16])
@pytest.mark.parametrize("kind", ["antiherm", "general"])
@pytest.mark.parametrize("norm", [0.5, 9.0])
def test_expm_norm_derived_squarings(norm, kind, d, dtype):
    """``expm`` picks the squaring count from the batch's largest 1-norm
    (norm 9 forces s >= 1 in both precisions)."""
    A = _matrix(kind, d, seed=20 + d, norm=norm, batch=(2,)).astype(dtype)
    want = np.asarray(ref.expm(A))
    got = port.expm(torch.from_numpy(A)).numpy()
    # squaring amplifies the base approximant's rounding by about 2^s
    assert _rel(got, want) < 8 * TOL[dtype]
    if kind == "antiherm":
        eye = np.eye(d)
        unit = got @ np.conj(np.swapaxes(got, -1, -2))
        assert np.max(np.abs(unit - eye)) < 1e3 * TOL[dtype]


@pytest.mark.parametrize("squarings", [0, 2])
def test_expm_static_squarings(squarings):
    """A static squaring count (an over-estimate is exact) agrees with the
    norm-derived one."""
    A = _matrix("antiherm", 8, seed=3, norm=1.0).astype(np.complex128)
    got = port.expm(torch.from_numpy(A), squarings=squarings).numpy()
    want = np.asarray(ref.expm(A))
    assert _rel(got, want) < 1e-12


def test_fact_inv_table_matches():
    assert port._FACT_INV == ref._FACT_INV
    assert port._B == ref._B
