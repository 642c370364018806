"""The last two TPU kernels' plain versions against the reference on the CPU:
``forward_scan_time_plain`` (K10) against ``forward_scan_pallas_time`` in
interpret mode, and ``karatsuba_chain_plain`` (K11) against the probe's
``pallas_karatsuba_chain`` run in TPU interpret mode.

The CUDA kernels behind ``forward_scan_time`` and ``karatsuba_chain`` run
only on the card (``chip_smoke.py`` holds them against these plain
versions there).  Here the wrappers, given CPU tensors, take the plain
versions.

Tolerances: float32 arithmetic in both, summed in another order: 1e-5
(the reference's own tolerance between its two forward kernels is 1e-6 at
this size; the plain version repeats the CUDA kernels' Taylor degree and
squaring count, not the Pallas kernel's order of sums).  The Karatsuba
chain is also held element by element against a complex128 chain to 1e-5
of its largest entry."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from grape_tpu.ops.pallas_prop import forward_scan_pallas_time

from grape_tpu_torch.ops import hopper_matmul, hopper_prop
from grape_tpu_torch.ops.hopper_matmul import (
    karatsuba_chain, karatsuba_chain_plain,
)
from grape_tpu_torch.ops.hopper_prop import (
    forward_scan_pertraj_plain, forward_scan_time, forward_scan_time_plain,
)

torch.set_num_threads(1)

_PROBE = os.path.join(os.path.dirname(__file__), os.pardir, "experiments",
                      "mxu_probe.py")


def _load_probe():
    """The reference probe module, loaded from its path (it is no package
    module)."""
    spec = importlib.util.spec_from_file_location("mxu_probe_reference",
                                                  _PROBE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _time_inputs(K=3, d=8, T=2, N_T=6, seed=3):
    """The inputs of the reference's own K10 test (``tests/test_pallas.py``)."""
    rng = np.random.default_rng(seed)
    H0 = rng.normal(size=(K, d, d))
    H0 = (H0 + np.swapaxes(H0, -1, -2)) + 0j
    ops = rng.normal(size=(K, T, d, d))
    ops = (ops + np.swapaxes(ops, -1, -2)) + 0j
    coeffs = rng.normal(size=(N_T, T)).astype(np.float32) * 0.3
    dts = np.full(N_T, 0.1, dtype=np.float32)
    psi0 = rng.normal(size=(K, d)) + 1j * rng.normal(size=(K, d))
    psi0 /= np.linalg.norm(psi0, axis=1, keepdims=True)
    return (H0.astype(np.complex64), ops.astype(np.complex64), coeffs, dts,
            psi0.astype(np.complex64))


@pytest.mark.parametrize("s", [0, 2])
def test_forward_scan_time_plain_matches_pallas_interpret(s):
    H0, ops, coeffs, dts, psi0 = _time_inputs()
    ref = np.asarray(forward_scan_pallas_time(
        jnp.asarray(H0), jnp.asarray(ops), coeffs, dts, jnp.asarray(psi0),
        n_squarings=s, interpret=True,
    ))
    args = [torch.as_tensor(x) for x in (H0, ops, coeffs, dts, psi0)]
    out = forward_scan_time_plain(*args, s)
    assert out.shape == (7, 3, 8) and out.dtype == torch.complex64
    assert np.max(np.abs(out.numpy() - ref)) < 1e-5
    # the wrapper takes the plain version for CPU tensors and counts no
    # launch; K10 is K5 without the propagator stream
    before = dict(hopper_prop.launches)
    assert torch.equal(forward_scan_time(*args, s), out)
    storage, U = forward_scan_pertraj_plain(*args, s, with_propagators=False)
    assert U is None and torch.equal(storage, out)
    assert hopper_prop.launches == before


def test_forward_scan_time_rejects_other_degrees():
    args = [torch.as_tensor(x) for x in _time_inputs()]
    with pytest.raises(ValueError, match="degree=16"):
        forward_scan_time(*args, 0, degree=12)


def _karatsuba_inputs(B, D, seed):
    """The probe's operands: b scaled to spectral radius below one."""
    rng = np.random.default_rng(seed)
    a = [rng.normal(size=(B, D, D)).astype(np.float32) for _ in range(2)]
    s = np.float32(1.0 / (1.05 * np.sqrt(2.0 * D)))
    b = [(s * rng.normal(size=(B, D, D))).astype(np.float32)
         for _ in range(2)]
    return a[0], a[1], b[0], b[1]


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_karatsuba_chain_plain_matches_pallas_interpret(precision):
    B, D, reps = 2, 8, 4
    ar, ai, br, bi = _karatsuba_inputs(B, D, seed=0)
    probe = _load_probe()
    with pltpu.force_tpu_interpret_mode():
        f = probe.pallas_karatsuba_chain(D, B, reps, precision)
        ref_sum = float(f(ar, ai, br, bi))
    tens = [torch.as_tensor(x) for x in (ar, ai, br, bi)]
    c = karatsuba_chain_plain(*tens, reps, precision)
    assert c.shape == (B, D, D) and c.dtype == torch.complex64
    got_sum = float(c.real.sum() + c.imag.sum())
    assert abs(got_sum - ref_sum) < 1e-5 * max(1.0, abs(ref_sum))
    # element by element against the complex128 chain c <- c b
    want = (ar + 1j * ai).astype(np.complex128)
    b = (br + 1j * bi).astype(np.complex128)
    for _ in range(reps):
        want = want @ b
    scale = np.max(np.abs(want))
    assert np.max(np.abs(c.numpy() - want)) < 1e-5 * scale
    before = dict(hopper_matmul.launches)
    assert torch.equal(karatsuba_chain(*tens, reps, precision), c)
    assert hopper_matmul.launches == before


def test_karatsuba_chain_checks_arguments():
    tens = [torch.as_tensor(x) for x in _karatsuba_inputs(1, 4, seed=1)]
    with pytest.raises(ValueError, match="precision"):
        karatsuba_chain_plain(*tens, 2, "high")
    with pytest.raises(ValueError, match="shape"):
        karatsuba_chain_plain(tens[0], tens[1][:, :3, :3], tens[2],
                              tens[3], 2)
    # zero products: the chain returns a itself
    c = karatsuba_chain(*tens, 0)
    assert torch.equal(c, torch.complex(tens[0], tens[1]))
