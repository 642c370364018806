"""Published peaks of one NVIDIA H100 SXM (dense, at the 700 W limit)."""

__all__ = ["PEAK_FP32_FLOPS", "PEAK_BYTES", "bound"]

PEAK_FP32_FLOPS = 67e12   # float32 outside the tensor cores
PEAK_BYTES = 3.35e12      # HBM3


def bound(flops, byts):
    """``(ms, "operations" or "bytes")``: the least time the card could
    take, operations at the float32 peak or bytes at the memory rate."""
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = byts / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")
