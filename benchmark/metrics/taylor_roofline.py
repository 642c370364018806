"""``taylor_roofline``: the time-vectorized Taylor pass's bound time over
its device time in the profiled slice.  The bound is the float32
operations that the pass needs (``counts/taylor.pass_flops``) at the order
count that each gradient evaluation's own largest pulse values need
(``counts/envelope.taylor_orders``), summed over the gradient evaluations
of the slice, at the float32 peak: at the cell's shapes its tensors (some
hundred MB an order, about 3 ms an evaluation at the memory rate against
about 20 ms of operations) leave the pass bound by its operations.  The
device time is ``taylor_pass_ms``'s: the work launched inside the port's
``grape.taylor_pass`` spans.  Reads nothing where the slice holds no such
span or no device event."""

from benchmark.counts import envelope, peaks, taylor
from benchmark.metrics.taylor_pass_ms import pass_device


def slice_evaluations(ctx, kind=None):
    """The benchmark's evaluation spans ``(t0, t1, kind, amplitudes)``
    that lie inside the profiled slice (only those of ``kind``, where
    given)."""
    rec = ctx.recorder
    if rec is None or not rec.slice:
        return []
    lo, hi = rec.slice
    return [sp for sp in rec.spans if lo <= sp[0] and sp[1] <= hi + 1e-9
            and (kind is None or sp[2] == kind)]


def orders(structure, amplitudes):
    """The Taylor pass's order count at the pulse's largest values."""
    st = structure
    norm = envelope.step_norm(st["dt"], st["h0_norm"], st["op_norms"],
                              amplitudes)
    return envelope.taylor_orders(
        norm, max(st["op_norms"]) / max(norm / st["dt"], 1e-30))


def read(ctx):
    rec = ctx.recorder
    if rec is None or not rec.events:
        return None
    us, n = pass_device(rec.events)
    evals = slice_evaluations(ctx, "evaluate_gradient")
    if not us or not n or not evals:
        return None
    st = ctx.structure
    flops = 0.0
    for _, _, _, amps in evals:
        m = orders(st, amps)
        if m is None:
            return None
        flops += taylor.pass_flops(st["d"], st["K"], st["L"], st["N_T"], m)
    return flops / peaks.PEAK_FP32_FLOPS / (us / 1e6) * 100.0
