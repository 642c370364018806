"""Bare batched complex-matmul ceiling probe on the card.

    python -m grape_tpu_torch.experiments.mxu_probe

Counterpart of ``experiments/mxu_probe.py``: what one GPU delivers for the
chains of batched d x d complex float32 products that the optimizer's
kernels are made of, and how long a call and a synchronisation take:

1. ``torch_c64_chain``: ``reps`` products ``c ← c @ b`` of complex64
   batches through ``torch.matmul`` (a library yardstick);
2. ``torch_karatsuba_chain``: the same in the Karatsuba form on float32
   planes (three real products each; a library yardstick);
3. ``karatsuba_chain_kernel``: the hand-written kernel
   (``ops.hopper_matmul.karatsuba_chain``, ``csrc/karatsuba_chain.cu``)
   with the operands in shared memory, the counterpart of the reference's
   Pallas kernel with its operands in VMEM;
4. ``per_call_floor`` and the pipelining probe: one launch and
   synchronisation of a trivial operation, and ten un-synchronised calls
   of a short chain against the synchronised call.

Precision ``"highest"`` is full float32 (``allow_tf32`` off, the kernel's
FMAs); ``"default"`` is the card's counterpart of the TPU's one-pass
reduced-precision product: TF32 (``allow_tf32`` on for the library
chains, the kernel's TF32 tensor-core path).  No chain of the optimizer
uses TF32.

FLOPs are counted as the reference counts them: 8·D³ per complex product
of the unpadded D.  Rates are reported against 67 TFLOP/s (float32 outside
the tensor cores) and 495 TFLOP/s (dense TF32) of an H100 SXM at 700 W;
every line carries the card's name and power limit.  One JSON line per
probe.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

__all__ = ["main", "run_probe", "operands", "PEAK_FP32", "PEAK_TF32"]

PEAK_FP32 = 67e12   # float32 outside the tensor cores
PEAK_TF32 = 495e12  # TF32 tensor cores, dense


def _card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return out


def operands(B, d, seed=0, device="cuda"):
    """Float32 planes ``(ar, ai, br, bi)`` of shape ``(B, d, d)`` on the
    card; ``b`` scaled to spectral radius below one so long chains neither
    overflow nor underflow."""
    rng = np.random.default_rng(seed)
    a = [rng.normal(size=(B, d, d)).astype(np.float32) for _ in range(2)]
    s = np.float32(1.0 / (1.05 * np.sqrt(2.0 * d)))
    b = [(s * rng.normal(size=(B, d, d))).astype(np.float32)
         for _ in range(2)]
    return [torch.as_tensor(x, device=device) for x in (*a, *b)]


class _tf32:
    """Within the block, library float32 products may use TF32 when
    ``on`` (restored after)."""

    def __init__(self, on):
        self.on = on

    def __enter__(self):
        self.old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.on

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.old


def c64_chain(ar, ai, br, bi, reps):
    """``reps`` complex64 products through ``torch.matmul``; the sum of
    the real and imaginary parts of the result."""
    c = torch.complex(ar, ai)
    b = torch.complex(br, bi)
    for _ in range(reps):
        c = c @ b
    return c.real.sum() + c.imag.sum()


def karatsuba_torch_chain(ar, ai, br, bi, reps):
    """The Karatsuba chain on float32 planes through ``torch.matmul``."""
    cr, ci = ar, ai
    bs = br + bi
    for _ in range(reps):
        t1 = cr @ br
        t2 = ci @ bi
        t3 = (cr + ci) @ bs
        cr, ci = t1 - t2, t3 - t1 - t2
    return cr.sum() + ci.sum()


def timeit(fn, n=2):
    """Host seconds per call of ``fn`` (one warm call first), each call
    ended by reading its scalar result (a synchronisation)."""
    assert np.isfinite(float(fn()))
    t0 = time.perf_counter()
    acc = 0.0
    for _ in range(n):
        acc += float(fn())
    dt = (time.perf_counter() - t0) / n
    assert np.isfinite(acc), acc
    return dt


def _line(name, dt, flops, card, extra=None):
    out = {
        "probe": name, "ms": dt * 1e3,
        "tflops": flops / dt / 1e12 if dt > 0 else 0.0,
        "share_of_fp32_peak": flops / dt / PEAK_FP32 if dt > 0 else 0.0,
        "share_of_tf32_peak": flops / dt / PEAK_TF32 if dt > 0 else 0.0,
        "card": card,
    }
    if extra:
        out.update(extra)
    return out


def run_probe(B=512, reps=256, dims=(100, 128), stream_batch=8192,
              emit=None, device="cuda"):
    """Run every probe; returns the list of result dictionaries (and hands
    each to ``emit`` as it is made)."""
    from ..ops.hopper_matmul import karatsuba_chain

    card = _card()
    lines = []

    def out(obj):
        lines.append(obj)
        if emit is not None:
            emit(obj)

    # per-call floor: a trivial launch and a scalar read
    xs = torch.ones(8, device=device)
    out(_line("per_call_floor", timeit(lambda: xs.sum(), n=20), 0.0, card))

    for d in dims:
        args = operands(B, d, device=device)
        flops = 8.0 * d ** 3 * B * reps
        for prec in ("highest", "default"):
            with _tf32(prec == "default"):
                dt = timeit(lambda: c64_chain(*args, reps))
                out(_line(f"torch_c64_chain_d{d}_{prec}", dt, flops, card,
                          {"batch": B, "reps": reps}))
                dt = timeit(lambda: karatsuba_torch_chain(*args, reps))
                out(_line(f"torch_karatsuba_chain_d{d}_{prec}", dt, flops,
                          card, {"batch": B, "reps": reps}))
            dt = timeit(lambda: (
                lambda c: c.real.sum() + c.imag.sum())(
                    karatsuba_chain(*args, reps, prec)))
            out(_line(f"karatsuba_chain_kernel_d{d}_{prec}", dt, flops,
                      card, {"batch": B, "reps": reps,
                             "route": "cuda",
                             "source": "grape_tpu_torch/csrc/"
                                       "karatsuba_chain.cu"}))
        del args

    # streaming batched product (reps = 1, large batch): the regime of a
    # product that reads its operands from device memory
    args = operands(stream_batch, 128, device=device)
    dt = timeit(lambda: c64_chain(*args, 1))
    out(_line("torch_c64_stream_d128_highest", dt,
              8.0 * 128 ** 3 * stream_batch, card,
              {"batch": stream_batch, "reps": 1}))
    del args

    # pipelining: can ten un-synchronised calls hide the per-call floor?
    args = operands(128, 128, device=device)
    fn = lambda: c64_chain(*args, 8)
    float(fn())
    n_pipe = 10
    t0 = time.perf_counter()
    outs = [fn() for _ in range(n_pipe)]
    mid = time.perf_counter() - t0
    acc = float(outs[-1]) + float(outs[0])
    dt_all = (time.perf_counter() - t0) / n_pipe
    assert np.isfinite(acc)
    dt_sync = timeit(fn, n=4)
    out({"probe": "pipelining_10_dispatch_1_sync",
         "ms_per_call_pipelined": dt_all * 1e3,
         "ms_dispatch_only": mid / n_pipe * 1e3,
         "ms_per_call_synced": dt_sync * 1e3, "card": card})
    return lines


def main():
    if not torch.cuda.is_available():
        print("the probe needs a CUDA device: torch.cuda.is_available() is "
              "False", file=sys.stderr)
        return 2
    dev = torch.cuda.get_device_name(0)
    print(json.dumps({"platform": "gpu", "device": dev}), flush=True)
    run_probe(emit=lambda obj: print(json.dumps(obj), flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
