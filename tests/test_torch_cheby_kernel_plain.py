"""The Chebyshev-scan kernel's plain version against the two TPU kernels it
replaces, on the CPU: ``cheby_scan_plain`` against
``cheby_scan_pallas_shared`` and ``cheby_scan_pallas_stream`` in interpret
mode (four interpret calls), forward and adjoint, on the reference test's
shape (d = 256, K = 2, N_T = 3) and its tables; the wrapper's route on CPU
tensors; and the routing gate against the reference's.

The plain version repeats the CUDA kernel's function (same normalisation,
same zero-padded table rows) and is what ``chip_smoke.py`` holds the kernel
against on the card.  Tolerance: 2e-5 absolute on unit-norm states (float32
on both sides, the reference's own kernel-test tolerance)."""

import numpy as np
import pytest
import torch

from grape_tpu import fg as ref_fg
from grape_tpu.functionals import J_T_sm as ref_J_T_sm
from grape_tpu.ops.pallas_prop import (
    cheby_scan_pallas_shared, cheby_scan_pallas_stream,
)

import grape_tpu_torch as gt
from grape_tpu_torch import fg as port_fg
from grape_tpu_torch.ops import hopper_cheby
from grape_tpu_torch.ops.hopper_cheby import cheby_scan, cheby_scan_plain

from tests.test_torch_cheby import (
    _port_of, _ref_cz, _ref_distinct, _ref_shared_256,
)

torch.set_num_threads(1)


def _kernel_inputs(adjoint):
    """The reference test's inputs: H0, ops, coefficients, the tables of
    ``_cheby_data`` at amp_max 0.4, and the initial block (reversed basis
    states for the adjoint)."""
    cp = _ref_shared_256()
    pd = ref_fg._cheby_data(cp, np.array([0.4]))
    coeffs = (np.einsum("ntl,ln->nt", np.asarray(cp.M), cp.guess_pulsevals)
              + np.asarray(cp.Mfix)).astype(np.float32)
    psi0 = np.asarray(cp.psi0)
    if adjoint:
        psi0 = psi0[::-1].copy()
    key = "bw" if adjoint else "fw"
    return (cp.H0[0], cp.ops[0], coeffs, pd[f"tab_{key}"], pd[f"ph_{key}"],
            pd["shift"], pd["dE"], psi0)


def _plain(args, adjoint):
    H0, ops, coeffs, tab, ph, shift, dE, psi0 = args
    t = torch.as_tensor
    return cheby_scan_plain(t(H0), t(ops), t(coeffs), t(tab), t(ph), shift,
                            dE, t(psi0), adjoint=adjoint).numpy()


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("kernel", ["shared", "stream"])
def test_plain_matches_pallas(kernel, adjoint):
    args = _kernel_inputs(adjoint)
    pallas = {"shared": cheby_scan_pallas_shared,
              "stream": cheby_scan_pallas_stream}[kernel]
    want = np.asarray(pallas(*args, adjoint=adjoint, interpret=True))
    got = _plain(args, adjoint)
    assert got.shape == want.shape == (3, 2, 256)
    assert got.dtype == np.complex64
    np.testing.assert_allclose(got, want, atol=2e-5)
    if adjoint:
        # row N_T - 1 is χ(T) itself: the state entering the last step
        assert np.array_equal(got[-1], args[-1])


def test_padded_terms_change_nothing():
    """Zero columns past a row's own length (the table's padding) leave the
    result as it is."""
    H0, ops, coeffs, tab, ph, shift, dE, psi0 = _kernel_inputs(False)
    padded = np.concatenate([tab, np.zeros((tab.shape[0], 3), tab.dtype)],
                            axis=1)
    a = _plain((H0, ops, coeffs, tab, ph, shift, dE, psi0), False)
    b = _plain((H0, ops, coeffs, padded, ph, shift, dE, psi0), False)
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_wrapper_takes_the_plain_version_on_cpu():
    args = [torch.as_tensor(a) if isinstance(a, np.ndarray) else a
            for a in _kernel_inputs(True)]
    before = dict(hopper_cheby.launches)
    out = cheby_scan(*args, adjoint=True)
    assert hopper_cheby.launches == before  # nothing launched
    np.testing.assert_array_equal(
        out.numpy(), cheby_scan_plain(*args, adjoint=True).numpy())


@pytest.mark.parametrize("case", [
    "shared_c64_d256", "shared_c128_d256", "shared_c64_d16",
    "per_trajectory_c64_d16", "newton_c64_d256",
])
def test_kernel_gate_matches_reference(case):
    """The kernel route is taken exactly where the reference's Pallas gate
    (``use_pallas=True``) takes its Chebyshev kernels."""
    dtype = np.complex128 if "c128" in case else np.complex64
    method = "newton" if case.startswith("newton") else "cheby"
    if case.endswith("d256"):
        cp_ref = _ref_shared_256(use_pallas=True)
        if dtype != np.complex64 or method != "cheby":
            cp_ref = ref_fg.compile_problem(
                cp_ref.trajectories, cp_ref.tlist, J_T=ref_J_T_sm,
                prop_method=method, gradient_method="taylor", dtype=dtype,
                use_pallas=True)
    elif case.startswith("per_trajectory"):
        cp_ref = _ref_distinct(prop_method=method, dtype=dtype,
                               use_pallas=True)
    else:
        cp_ref = _ref_cz(prop_method=method, dtype=dtype, use_pallas=True)
    cp = _port_of(cp_ref)
    pd_ref = ref_fg._prop_data(cp_ref)
    pds = port_fg._prop_data(cp)
    for key in ("fw", "bw"):
        assert port_fg._cheby_kernel_enabled(cp, pds[key]) == (
            ref_fg._pallas_cheby_enabled(cp_ref, pd_ref[key]))
    assert port_fg._cheby_kernel_enabled(cp, pds["fw"]) == (
        case == "shared_c64_d256")


def test_gate_dimension_bounds():
    """256 ≤ dim ≤ CHEBY_MAX_DIM, at least the reference's own ceiling
    (its streaming kernel's VMEM budget, 12·4·d² ≤ 100 MB)."""
    assert hopper_cheby.CHEBY_MAX_DIM >= int(np.sqrt(100 * 1024**2 / 48))
    assert port_fg._CHEBY_MIN_DIM == 256
    problem = gt.models.two_transmon_cz_problem(d=4, n_steps=3, T=1.0)
    cp = gt.compile_problem(problem.trajectories, problem.tlist,
                            device="cpu", dtype=np.complex64,
                            prop_method="cheby", **problem.kwargs)
    pd = port_fg._prop_data(cp)["fw"]
    for dim, want in ((255, False), (256, True),
                      (hopper_cheby.CHEBY_MAX_DIM, True),
                      (hopper_cheby.CHEBY_MAX_DIM + 1, False)):
        cp.dim = dim
        assert port_fg._cheby_kernel_enabled(cp, pd) == want
