"""grape_tpu_torch.ops.frechet.expm_frechet against the JAX package's on
the same seeded inputs.

Tolerances: complex128 to 1e-11 relative (Padé-13 with an LU solve on both
sides), complex64 to 2e-5 relative (degree-16 Taylor in float32; the
Fréchet chain is about ten products deep)."""

import numpy as np
import pytest
import torch

from grape_tpu.ops.frechet import expm_frechet as ref_expm_frechet
from grape_tpu_torch.ops.frechet import expm_frechet

torch.set_num_threads(1)

TOL = {np.complex128: 1e-11, np.complex64: 2e-5}


def _inputs(d, n_dirs, seed, norm, dtype):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(2, d, d)) + 1j * rng.normal(size=(2, d, d))
    A = -0.5j * (A + np.conj(np.swapaxes(A, -1, -2)))
    A *= norm / np.abs(A).sum(axis=-2).max()
    shape = (2, d, d) if n_dirs is None else (2, n_dirs, d, d)
    B = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    return A.astype(dtype), B.astype(dtype)


def _rel(a, b):
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
@pytest.mark.parametrize("squarings", [None, 0, 2])
@pytest.mark.parametrize("n_dirs", [None, 1, 3])
@pytest.mark.parametrize("d", [4, 16])
def test_expm_frechet_matches_reference(d, n_dirs, squarings, dtype):
    # a static count must bound the norm from above: keep ||A|| <= 2 for
    # squarings=0; the norm-derived case gets a norm that needs s >= 1
    norm = 7.0 if squarings is None else 1.5
    A, B = _inputs(d, n_dirs, seed=100 + d, norm=norm, dtype=dtype)
    E_ref, L_ref = ref_expm_frechet(A, B, squarings=squarings)
    E, L = expm_frechet(
        torch.from_numpy(A), torch.from_numpy(B), squarings=squarings
    )
    assert tuple(L.shape) == B.shape
    assert _rel(E.numpy(), np.asarray(E_ref)) < TOL[dtype]
    assert _rel(L.numpy(), np.asarray(L_ref)) < TOL[dtype]


def test_expm_frechet_is_the_directional_derivative():
    """L(A, B) against a central finite difference of expm (complex128)."""
    from grape_tpu_torch.ops.expm import expm

    A, B = _inputs(6, None, seed=5, norm=1.0, dtype=np.complex128)
    A, B = torch.from_numpy(A), torch.from_numpy(B)
    _, L = expm_frechet(A, B)
    h = 1e-6
    fd = (expm(A + h * B) - expm(A - h * B)) / (2 * h)
    assert float((L - fd).abs().max()) < 1e-8
