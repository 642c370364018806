"""The Krylov (Newton) propagator of ``grape_tpu_torch`` against
``grape_tpu``: ``arnoldi_expmv`` on non-Hermitian generators against the
reference's and against ``scipy.linalg.expm`` (1e-10 of the result's scale),
``build_fg`` under ``prop_method="newton"`` and under mixed per-direction
propagators against the reference's in complex128 (J to 1e-12, gradient to
1e-10 of its max), and the TLS optimization anchors."""

import numpy as np
import pytest
import scipy.linalg
import torch

import jax.numpy as jnp

from grape_tpu.ops.newton import arnoldi_expmv as ref_arnoldi_expmv

import grape_tpu_torch as gt
from grape_tpu_torch.functionals import J_T_sm
from grape_tpu_torch.ops.newton import arnoldi_expmv

from tests.test_torch_cheby import _ref_cz, _ref_distinct, _tls, fg_parity

torch.set_num_threads(1)


@pytest.mark.parametrize("K, d, scale, m, substeps", [
    (3, 20, 0.3, 30, 1),   # the reference's unit case
    (2, 12, 2.0, 30, 3),   # a large norm split into substeps
])
def test_arnoldi_expmv_against_reference(K, d, scale, m, substeps):
    rng = np.random.default_rng(substeps)
    A = -1j * scale * (rng.normal(size=(K, d, d))
                       + 1j * rng.normal(size=(K, d, d)))
    psi = rng.normal(size=(K, d)) + 1j * rng.normal(size=(K, d))
    psi /= np.linalg.norm(psi, axis=1, keepdims=True)
    At = torch.tensor(A)
    got = arnoldi_expmv(lambda v: torch.einsum("kij,kj->ki", At, v),
                        torch.tensor(psi), m=m, substeps=substeps).numpy()
    Aj = jnp.asarray(A)
    want = np.asarray(ref_arnoldi_expmv(
        lambda v: jnp.einsum("kij,kj->ki", Aj, v), jnp.asarray(psi), m=m,
        substeps=substeps))
    exact = np.stack([scipy.linalg.expm(A[k]) @ psi[k] for k in range(K)])
    scale_out = np.max(np.abs(exact))
    assert np.max(np.abs(got - want)) < 1e-10 * scale_out
    assert np.max(np.abs(got - exact)) < 1e-9 * scale_out


def test_arnoldi_expmv_zero_state_and_batch_axes():
    """A zero state stays zero; leading axes are batch axes."""
    rng = np.random.default_rng(2)
    A = torch.tensor(-0.5j * rng.normal(size=(2, 5, 5)))
    psi = torch.tensor(rng.normal(size=(2, 3, 5)) + 0j)
    psi[1, 2] = 0
    out = arnoldi_expmv(lambda v: v @ A.transpose(-1, -2), psi, m=5)
    assert torch.all(out[1, 2] == 0)
    exact = torch.stack([psi[g] @ torch.linalg.matrix_exp(A[g]).T
                         for g in range(2)])
    assert float((out - exact).abs().max()) < 1e-12


@pytest.mark.parametrize("layout", ["shared", "per_trajectory"])
@pytest.mark.parametrize("method", ["taylor", "gradgen"])
def test_fg_newton_complex128(method, layout):
    kw = dict(prop_method="newton", newton_m=10, gradient_method=method)
    cp_ref = _ref_cz(**kw) if layout == "shared" else _ref_distinct(**kw)
    fg_parity(cp_ref)


MIXED = {
    # expprop forward, newton co-states, cheby gradient generator (unused
    # by taylor): the reference's test_per_direction_prop_methods
    "fw_expprop_bw_newton_grad_cheby": dict(
        fw_prop_method="expprop", bw_prop_method="newton",
        grad_prop_method="cheby", newton_m=8, gradient_method="taylor"),
    "fw_cheby_grad_newton_gradgen": dict(
        fw_prop_method="cheby", grad_prop_method="newton", newton_m=8,
        gradient_method="gradgen"),
    "fw_newton_bw_cheby_taylor": dict(
        fw_prop_method="newton", bw_prop_method="cheby", newton_m=8,
        newton_substeps=2, gradient_method="taylor"),
}


@pytest.mark.parametrize("case", sorted(MIXED))
def test_fg_mixed_directions_complex128(case):
    fg_parity(_ref_cz(**MIXED[case]))


@pytest.mark.parametrize("gradient_method", ["gradgen", "taylor"])
def test_tls_with_newton(gradient_method):
    trajs, tlist = _tls()
    res = gt.optimize(
        trajs, tlist, iter_stop=5, J_T=J_T_sm, prop_method="newton",
        newton_m=6, gradient_method=gradient_method, device="cpu",
        rethrow_exceptions=True, print_iters=False,
    )
    assert res.J_T < 1e-3
    assert 0.75 < np.max(np.abs(res.optimized_controls[0])) < 0.85
