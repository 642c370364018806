"""Forward scan and co-state chain for a shared generator: CUDA kernels,
their wrappers and their plain PyTorch versions.

Counterpart of ``grape_tpu/ops/pallas_prop.py`` for the two kernels of the
gate-optimization main path:

- :func:`forward_scan_shared` replaces ``forward_scan_pallas_shared``: per
  step ``H_n = H0 + Σ_t c[n,t]·Op_t``, ``U_n = [Taylor-PS degree 16 of
  (−i·dt_n·H_n·2^−s)]^(2^s)``, ``ψ ← ψ·U_nᵀ`` for the ``(K, d)`` state
  block.  One wrapper, two device launches (``csrc/prop_scan.cu``): a
  batched propagator kernel over the independent time steps, then a
  sequential apply-scan.
- :func:`chi_scan_shared` replaces ``chi_scan_pallas_shared``: in reverse
  time emit ``chis[n] = χ(t_{n+1})``, then ``χ ← χ·conj(U_n)``.

Each wrapper launches its kernel for a CUDA tensor (or raises) and runs the
plain version only for a CPU tensor; ``launches`` counts kernel launches per
wrapper.  The kernels take complex64 only (full float32 FMAs).
"""

import torch

from . import plain_forced
from ._build import check, load_kernels
from .expm import expm_taylor_ps

__all__ = [
    "forward_scan_shared", "forward_scan_shared_plain",
    "chi_scan_shared", "chi_scan_shared_plain",
    "propagators_shared", "launches",
]

# kernel launches per wrapper (one count per wrapper call that launched)
launches = {"forward_scan_shared": 0, "chi_scan_shared": 0}

# blocks of the persistent propagator grid per multiprocessor
_BLOCKS_PER_SM = 2

# time steps per batched product of the plain propagators, so the
# (chunk, d, d) intermediates stay bounded
_PLAIN_CHUNK = 250


def _require(cond, msg):
    if not cond:
        raise ValueError(msg)


def _check_tensor(name, x, dtype, shape, device):
    _require(x.device == device, f"{name} is on {x.device}, not {device}")
    _require(x.dtype == dtype, f"{name} must be {dtype}, got {x.dtype}")
    _require(
        tuple(x.shape) == tuple(shape),
        f"{name} must have shape {tuple(shape)}, got {tuple(x.shape)}",
    )
    _require(x.is_contiguous(), f"{name} must be contiguous")


def _grid_blocks(device, n_items):
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(int(n_items), _BLOCKS_PER_SM * sms))


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _check_generator_args(H0, ops, coeffs, dts):
    """Validate the generator inputs shared by the propagator and the
    Fréchet kernels; returns ``(T, d, N_T)``."""
    device = H0.device
    d = H0.shape[-1]
    T = ops.shape[0]
    N_T = coeffs.shape[0]
    _check_tensor("H0", H0, torch.complex64, (d, d), device)
    _check_tensor("ops", ops, torch.complex64, (T, d, d), device)
    _check_tensor("coeffs", coeffs, torch.float32, (N_T, T), device)
    _check_tensor("dts", dts, torch.float32, (N_T,), device)
    _require(N_T >= 1, "need at least one time step")
    return T, d, N_T


def propagators_shared(H0, ops, coeffs, dts, n_squarings):
    """``U (N_T, d, d)`` by the batched propagator kernel (CUDA tensors
    only; the first of the two launches of :func:`forward_scan_shared`)."""
    T, d, N_T = _check_generator_args(H0, ops, coeffs, dts)
    device = H0.device
    _require(device.type == "cuda", "propagators_shared needs CUDA tensors")
    s = int(n_squarings)
    _require(0 <= s <= 32, f"n_squarings out of range: {s}")
    lib = load_kernels()
    n_blocks = _grid_blocks(device, N_T)
    n_mat = lib.grape_propagator_scratch_matrices()
    U = torch.empty((N_T, d, d), dtype=torch.complex64, device=device)
    scratch = torch.empty(
        (n_blocks * n_mat, d, d), dtype=torch.complex64, device=device
    )
    with torch.cuda.device(device):
        check(lib, lib.grape_propagators(
            H0.data_ptr(), ops.data_ptr(), coeffs.data_ptr(), dts.data_ptr(),
            T, d, N_T, s, scratch.data_ptr(), n_blocks, U.data_ptr(),
            _stream(device),
        ), "propagator kernel launch")
    return U


def _propagators_plain(H0, ops, coeffs, dts, n_squarings):
    cdtype = H0.dtype
    N_T = coeffs.shape[0]
    d = H0.shape[-1]
    s = int(n_squarings)
    scale = 2.0 ** (-s)
    U = torch.empty((N_T, d, d), dtype=cdtype, device=H0.device)
    chunk = _PLAIN_CHUNK
    for c0 in range(0, N_T, chunk):
        c = coeffs[c0:c0 + chunk].to(cdtype)
        dt = dts[c0:c0 + chunk].to(cdtype)
        H = H0[None] + torch.einsum("nt,tij->nij", c, ops)
        # A = -i dt H 2^-s  (Ar = dt Hi, Ai = -dt Hr)
        A = (-1j * dt * scale)[:, None, None] * H
        E = expm_taylor_ps(A)
        for _ in range(s):
            E = E @ E
        U[c0:c0 + chunk] = E
    return U


def forward_scan_shared_plain(H0, ops, coeffs, dts, psi0, n_squarings):
    """Plain PyTorch version of :func:`forward_scan_shared` (same Taylor
    degree, same static ``s``, same squarings)."""
    U = _propagators_plain(H0, ops, coeffs, dts, n_squarings)
    N_T = U.shape[0]
    K, d = psi0.shape
    storage = torch.empty((N_T + 1, K, d), dtype=psi0.dtype,
                          device=psi0.device)
    psi = psi0
    storage[0] = psi
    for n in range(N_T):
        psi = psi @ U[n].T  # row vectors: ψ_new = ψ·Uᵀ
        storage[n + 1] = psi
    return storage, U


def forward_scan_shared(H0, ops, coeffs, dts, psi0, n_squarings):
    """Forward propagation for a SHARED generator with the propagator
    stream.

    Args:
      H0:   (d, d) complex64 drift
      ops:  (T, d, d) complex64 control-term operators
      coeffs: (N_T, T) float32 per-step term coefficients
      dts:  (N_T,) float32 time steps
      psi0: (K, d) complex64 initial states
      n_squarings: squaring count ``s`` (a runtime integer here: a new value
        rebuilds nothing)

    Returns ``(storage (N_T+1, K, d), U (N_T, d, d))`` complex64, with
    ``storage[0] = psi0``.
    """
    if psi0.device.type == "cpu" or plain_forced():
        return forward_scan_shared_plain(
            H0, ops, coeffs, dts, psi0, n_squarings
        )
    K, d = psi0.shape
    _check_tensor("psi0", psi0, torch.complex64, (K, H0.shape[-1]), H0.device)
    U = propagators_shared(H0, ops, coeffs, dts, n_squarings)
    N_T = U.shape[0]
    device = psi0.device
    lib = load_kernels()
    storage = torch.empty((N_T + 1, K, d), dtype=torch.complex64,
                          device=device)
    with torch.cuda.device(device):
        check(lib, lib.grape_forward_apply(
            U.data_ptr(), psi0.data_ptr(), storage.data_ptr(), N_T, K, d,
            _stream(device),
        ), "forward apply-scan kernel launch")
    launches["forward_scan_shared"] += 1
    return storage, U


def chi_scan_shared_plain(Us, chi_hat):
    """Plain PyTorch version of :func:`chi_scan_shared`."""
    N_T = Us.shape[0]
    K, d = chi_hat.shape
    chis = torch.empty((N_T, K, d), dtype=chi_hat.dtype,
                       device=chi_hat.device)
    chi = chi_hat
    for n in range(N_T - 1, -1, -1):
        chis[n] = chi  # χ BEFORE the step-n update
        if n > 0:
            chi = chi @ Us[n].conj()
    return chis


def chi_scan_shared(Us, chi_hat):
    """Backward co-state chain over stored SHARED propagators.

    ``Us (N_T, d, d)`` complex64, ``chi_hat (K, d)`` complex64.  Returns
    ``chis (N_T, K, d)`` with ``chis[n] = χ(t_{n+1})``: χ is emitted, then
    updated by ``χ ← χ·conj(U_n)`` (row-vector form of ``U_n†χ``).
    """
    if chi_hat.device.type == "cpu" or plain_forced():
        return chi_scan_shared_plain(Us, chi_hat)
    device = chi_hat.device
    K, d = chi_hat.shape
    N_T = Us.shape[0]
    _check_tensor("Us", Us, torch.complex64, (N_T, d, d), device)
    _check_tensor("chi_hat", chi_hat, torch.complex64, (K, d), device)
    _require(N_T >= 1, "need at least one time step")
    lib = load_kernels()
    chis = torch.empty((N_T, K, d), dtype=torch.complex64, device=device)
    with torch.cuda.device(device):
        check(lib, lib.grape_chi_scan(
            Us.data_ptr(), chi_hat.data_ptr(), chis.data_ptr(), N_T, K, d,
            _stream(device),
        ), "chi scan kernel launch")
    launches["chi_scan_shared"] += 1
    return chis
