"""Standalone propagation utilities, the counterpart of
``grape_tpu.propagate``: simulate the dynamics under a generator
(optionally storing every intermediate state), and replace a generator's
controls with optimized pulse vectors.
"""

import math

import numpy as np
import torch

from .amplitudes import ShapedAmplitude
from .config import (
    complex_dtype, default_complex, numpy_dtype, resolve_device, torch_dtype,
)
from .controls import discretize_on_midpoints, get_controls
from .fg import _expm_steps, coefficient_columns
from .generators import Generator, as_generator
from .ops.expm import _THETA_TAYLOR_F32
from .ops.hopper_prop import forward_scan_shared

__all__ = ["propagate", "substitute"]

# steps whose exponentials the plain complex128 path forms at once
_PLAIN_CHUNK = 256


def substitute(generator, mapping):
    """Return a copy of `generator` with controls replaced per `mapping`
    (a list of ``(old_control, new_control)`` pairs or a dict-like of
    id-matched controls)."""
    if isinstance(mapping, dict):
        pairs = list(mapping.items())
    else:
        pairs = list(mapping)

    def replace(control):
        for old, new in pairs:
            if control is old:
                return new
        return control

    new_terms = []
    for op, amp in generator.terms:
        if isinstance(amp, ShapedAmplitude):
            new_terms.append(
                (op, ShapedAmplitude(replace(amp.control), amp.shape))
            )
        else:
            new_terms.append((op, replace(amp)))
    return Generator(generator.drift, new_terms)


def _squarings(H0, ops, coeffs, dts):
    """Squaring count of the degree-16 Taylor polynomial from the host
    bound ``max_n |dt_n|·(‖H0‖₁ + Σ_t |c_nt|·‖Op_t‖₁)`` on the operators
    as given (the adjoints for a backward run: their 1-norm is not the
    generator's where it is not Hermitian)."""
    h0n = float(np.abs(H0).sum(axis=0).max())
    opn = np.asarray([float(np.abs(op).sum(axis=0).max()) for op in ops])
    bound = float(np.max(np.abs(dts) * (h0n + np.abs(coeffs) @ opn)))
    return max(0, math.ceil(math.log2(max(bound, 1e-30) / _THETA_TAYLOR_F32)))


def propagate(state, generator, tlist, storage=False, backwards=False,
              dtype=None, device=None):
    """Propagate `state` under `generator` over `tlist` (piecewise-constant
    exponential propagation) and return numpy arrays: with
    ``storage=True`` all states ``(N_T+1, d)``, otherwise the final state
    ``(d,)``.  ``backwards=True`` propagates with ``H → H†`` over the steps
    in reverse order, ``ψ ← exp(+i dt_n H_n†) ψ``.

    The generator may be any :class:`Generator` (``CustomAmplitude`` terms
    included; their coefficient columns are evaluated as ``build_fg`` does)
    or a plain matrix; it need not be Hermitian.  ``device=None`` means the
    CUDA device and raises without one; ``dtype=None`` is
    :func:`~grape_tpu_torch.config.default_complex` of the device.

    The arithmetic follows the dtype, as in ``build_fg``: complex64 runs
    the forward scan of a shared generator (``ops.hopper_prop.
    forward_scan_shared``: the propagator kernel, then the state scan) on
    the card, and its plain PyTorch version on the CPU, with the degree-16
    Taylor polynomial and one squaring count from the host bound of every
    step's ``|dt|·‖H‖₁``; a backward run hands the kernel the adjoint
    operators, the coefficient rows in reverse order and the negated steps.
    complex128 (the CPU default, or asked for on the card) runs Padé-13
    with each step's own squaring count, step by step, which is the
    reference's arithmetic in double precision.  That path is chosen by the
    dtype alone: complex64 on the card always launches the kernels, and a
    failure to build or launch them raises.  The kernel path forms the
    whole propagator stream ``(N_T, d, d)`` even with ``storage=False``
    (160 MB at d = 100 and N_T = 2000).
    """
    device = resolve_device(device)
    cdtype = complex_dtype(numpy_dtype(
        default_complex(device) if dtype is None else dtype))
    generator = as_generator(generator)  # plain static matrices allowed
    tlist = np.asarray(tlist, dtype=np.float64)
    N_T = len(tlist) - 1
    controls = get_controls(generator)
    eps = (
        np.stack([discretize_on_midpoints(c, tlist) for c in controls])
        if controls else np.zeros((1, N_T))
    )
    M, Mfix = generator.coefficient_tables(tlist, controls)
    custom = generator.custom_terms(controls)
    f64 = dict(dtype=torch.float64, device=device)
    coeffs, _ = coefficient_columns(
        torch.as_tensor(M, **f64), torch.as_tensor(Mfix, **f64),
        torch.as_tensor(tlist, **f64), torch.as_tensor(eps, **f64), custom,
        derivatives=False,
    )
    coeffs = coeffs.cpu().numpy()  # (N_T, T) float64
    H0 = np.asarray(generator.drift, dtype=np.complex128)
    if generator.terms:
        ops = np.stack([np.asarray(op, dtype=np.complex128)
                        for op, _ in generator.terms])
    else:  # a static generator: one zero term keeps the kernel's layout
        ops = np.zeros((1,) + H0.shape, dtype=np.complex128)
        coeffs = np.zeros((N_T, 1))
    dts = np.diff(tlist)
    if backwards:
        H0 = H0.conj().T
        ops = ops.conj().transpose(0, 2, 1)
        coeffs = coeffs[::-1]
        dts = -dts[::-1]
    psi0 = np.asarray(state, dtype=cdtype)

    tdt = torch_dtype(cdtype)
    c = lambda x: torch.as_tensor(np.ascontiguousarray(x), dtype=tdt,
                                  device=device)
    if cdtype == np.complex64:
        r = lambda x: torch.as_tensor(np.ascontiguousarray(x),
                                      dtype=torch.float32, device=device)
        states, _U = forward_scan_shared(
            c(H0), c(ops), r(coeffs), r(dts), c(psi0[None]),
            _squarings(H0, ops, coeffs, dts),
        )
        states = states[:, 0]
    else:
        H0_t, ops_t = c(H0), c(ops)
        co = c(coeffs)
        a = c(-1j * dts)
        psi = c(psi0)
        out = [psi]
        for n0 in range(0, N_T, _PLAIN_CHUNK):
            sl = slice(n0, n0 + _PLAIN_CHUNK)
            H = H0_t[None] + torch.einsum("nt,tij->nij", co[sl], ops_t)
            Us = _expm_steps((a[sl, None, None] * H)[:, None])[:, 0]
            for U in Us:
                psi = U @ psi
                out.append(psi)
        states = torch.stack(out)
    if storage:
        return states.cpu().numpy()
    return states[-1].cpu().numpy()
