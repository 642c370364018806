"""``lbfgsb_ms``: the native L-BFGS-B's own time an iteration: the port's
``grape.lbfgsb`` spans (each call of the C++ step with its task message)
in the profiled slice, summed, over the iterations whose end lies in the
slice.  Reads nothing where the slice holds no such span (another
optimizer, or a program without the spans)."""

from benchmark.metrics.idle_eval import host_spans


def read(ctx):
    rec = ctx.recorder
    if rec is None or not rec.events or not rec.slice:
        return None
    spans = host_spans(rec.events, ("grape.lbfgsb",))
    lo, hi = rec.slice
    n = sum(lo < e <= hi + 1e-9 for e in ctx.window.iter_end)
    if not spans or not n:
        return None
    return sum(b - a for a, b in spans) / 1e3 / n
