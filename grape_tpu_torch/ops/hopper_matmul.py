"""Chains of complex matrix products with the operands on chip: the CUDA
kernel of the throughput probe, its wrapper and its plain PyTorch version.

Counterpart of ``pallas_karatsuba_chain`` (``experiments/mxu_probe.py``):
for each batch item, starting from ``c = a``, ``reps`` complex products
``c ← c·b`` in the Karatsuba form (three real products:
``t1 = cr·br``, ``t2 = ci·bi``, ``t3 = (cr+ci)·(br+bi)``,
``cr ← t1 − t2``, ``ci ← t3 − t1 − t2``).  :func:`karatsuba_chain` runs
``csrc/karatsuba_chain.cu``: each block owns 32 rows of one item's ``c``
and keeps all of ``b`` in shared memory, so the chain needs no
synchronisation between blocks; ``precision="highest"`` multiplies in full
float32 FMAs (the regime of the optimizer's kernels), ``"default"`` on the
TF32 tensor cores (the counterpart of the TPU's one-pass reduced-precision
product; a probe only).  It is used by the probe
(``python -m grape_tpu_torch.experiments.mxu_probe``), not by the
optimizer.
"""

import torch

from . import plain_forced
from ._build import check, load_kernels

__all__ = ["karatsuba_chain", "karatsuba_chain_plain", "launches",
           "KARATSUBA_MAX_DIM"]

# wrapper calls that launched their kernel
launches = {"karatsuba_chain": 0}

# largest D: two float32 planes of b in one block's shared memory
KARATSUBA_MAX_DIM = 128

_PRECISIONS = ("highest", "default")


def _check_args(ar, ai, br, bi, reps, precision):
    if precision not in _PRECISIONS:
        raise ValueError(
            f"precision must be one of {_PRECISIONS}, got {precision!r}")
    if int(reps) < 0:
        raise ValueError(f"reps must be >= 0, got {reps}")
    if ar.ndim != 3 or ar.shape[1] != ar.shape[2]:
        raise ValueError(f"ar must be (B, D, D), got {tuple(ar.shape)}")
    for name, x in (("ai", ai), ("br", br), ("bi", bi)):
        if tuple(x.shape) != tuple(ar.shape):
            raise ValueError(f"{name} must have the shape of ar "
                             f"{tuple(ar.shape)}, got {tuple(x.shape)}")
        if x.device != ar.device or x.dtype != ar.dtype:
            raise ValueError(f"{name} must be {ar.dtype} on {ar.device}")


def karatsuba_chain_plain(ar, ai, br, bi, reps, precision="highest"):
    """Plain PyTorch version of :func:`karatsuba_chain`: the same Karatsuba
    recursion in float32 batched products (``precision`` is checked, not
    used: the plain version multiplies in full float32)."""
    _check_args(ar, ai, br, bi, reps, precision)
    cr, ci = ar, ai
    bs = br + bi
    for _ in range(int(reps)):
        t1 = cr @ br
        t2 = ci @ bi
        t3 = (cr + ci) @ bs
        cr, ci = t1 - t2, t3 - t1 - t2
    return torch.complex(cr, ci)


def karatsuba_chain(ar, ai, br, bi, reps, precision="highest"):
    """``reps`` complex products ``c ← c·b`` per batch item from ``c = a``.

    Args:
      ar, ai: (B, D, D) float32, the real and imaginary planes of ``a``
      br, bi: (B, D, D) float32, those of ``b``
      reps: chain length
      precision: ``"highest"`` (float32 FMAs) or ``"default"`` (TF32
        tensor cores)

    Returns ``c (B, D, D)`` complex64.  CUDA tensors launch the kernel
    (``D ≤ 128``); CPU tensors run :func:`karatsuba_chain_plain`.
    """
    if ar.device.type == "cpu" or plain_forced():
        return karatsuba_chain_plain(ar, ai, br, bi, reps, precision)
    _check_args(ar, ai, br, bi, reps, precision)
    B, D, _ = ar.shape
    if ar.dtype != torch.float32:
        raise ValueError(f"the planes must be float32, got {ar.dtype}")
    if D > KARATSUBA_MAX_DIM:
        raise ValueError(
            f"karatsuba_chain takes D <= {KARATSUBA_MAX_DIM}, got {D}")
    for name, x in (("ar", ar), ("ai", ai), ("br", br), ("bi", bi)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    device = ar.device
    lib = load_kernels()
    out = torch.empty((B, D, D), dtype=torch.complex64, device=device)
    with torch.cuda.device(device):
        check(lib, lib.grape_karatsuba_chain(
            ar.data_ptr(), ai.data_ptr(), br.data_ptr(), bi.data_ptr(),
            out.data_ptr(), B, D, int(reps), int(precision == "default"),
            torch.cuda.current_stream(device).cuda_stream,
        ), "Karatsuba chain kernel launch")
    launches["karatsuba_chain"] += 1
    return out
