"""Numeric configuration and device selection for grape_tpu_torch.

The reference implementation (GRAPE.jl) runs everything in
Float64/ComplexF64.  The port keeps both precisions explicit: complex128
reproduces the reference's 1e-10..1e-14 tolerance anchors (plain PyTorch
path), complex64 is the working precision of the hand-written CUDA kernels.

Every entry point takes ``device=None``, which means "the CUDA device" and
raises when there is none: nothing in this package falls back to the CPU on
its own.  Callers that want the CPU (the tests) pass ``device="cpu"``.
"""

import numpy as np
import torch

__all__ = [
    "real_dtype", "complex_dtype", "default_float", "default_complex",
    "torch_dtype", "numpy_dtype", "resolve_device",
]

# Plain float32 matrix products must stay full float32: TF32 keeps about
# three decimal digits, which breaks unitarity over long propagations.
torch.backends.cuda.matmul.allow_tf32 = False

_TORCH_OF_NUMPY = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.complex128): torch.complex128,
}
_NUMPY_OF_TORCH = {v: k for k, v in _TORCH_OF_NUMPY.items()}


def default_complex(device=None):
    """The widest complex dtype the port computes in on ``device`` (numpy
    dtype): complex128 on the CPU (the plain PyTorch versions, Padé-13),
    complex64 on the card (the hand-written kernels' precision).  The
    reference asks JAX's x64 switch; the port asks the device.
    ``device=None`` means the CUDA device and raises without one."""
    device = resolve_device(device)
    return np.dtype(np.complex64 if device.type == "cuda"
                    else np.complex128)


def default_float(device=None):
    """The real dtype matching :func:`default_complex` on ``device``."""
    return real_dtype(default_complex(device))


def numpy_dtype(dtype):
    """``dtype`` (numpy or torch) as a numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return _NUMPY_OF_TORCH[dtype]
    return np.dtype(dtype)


def torch_dtype(dtype):
    """``dtype`` (numpy or torch) as a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH_OF_NUMPY[np.dtype(dtype)]


def real_dtype(dtype):
    """The real dtype matching a given (possibly complex) dtype; a numpy
    dtype in gives a numpy dtype out, a torch dtype a torch dtype."""
    nd = numpy_dtype(dtype)
    out = np.dtype(np.float64 if nd in (np.complex128, np.float64)
                   else np.float32)
    return torch_dtype(out) if isinstance(dtype, torch.dtype) else out


def complex_dtype(dtype):
    """The complex dtype matching a given (possibly real) dtype."""
    nd = numpy_dtype(dtype)
    out = np.dtype(np.complex128 if nd in (np.complex128, np.float64)
                   else np.complex64)
    return torch_dtype(out) if isinstance(dtype, torch.dtype) else out


def resolve_device(device=None):
    """The ``torch.device`` an entry point runs on.  ``None`` means the
    CUDA device and raises if there is none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "grape_tpu_torch runs on a CUDA device unless told otherwise "
            "and torch.cuda.is_available() is False; pass device='cpu' "
            "explicitly to run the plain PyTorch versions on the CPU"
        )
    return device
