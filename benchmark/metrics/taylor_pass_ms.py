"""``taylor_pass_ms``: the card's time an evaluation in the time-vectorized
Taylor pass: the device time of the kernels, copies and sets that the host
launched inside the port's ``grape.taylor_pass`` spans of the profiled
slice (each launch matched to its device operation by the trace's
``correlation`` id, so work that runs after the span has closed counts
too), over the gradient evaluations (``grape.evaluate_gradient`` spans)
that hold such a span.  Also the attribution that ``taylor_roofline``
shares.  Reads nothing where the slice holds no such span (a program
without it) or no device event (the CPU)."""

import bisect

from benchmark.harness.readings import union
from benchmark.metrics.idle_eval import host_spans

PASS = ("grape.taylor_pass",)
GRADIENT = ("grape.evaluate_gradient",)
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _correlation(event):
    args = event.get("args") or {}
    return args.get("correlation")


def pass_device(events):
    """``(device µs, evaluations)``: the device time of the work launched
    inside ``grape.taylor_pass`` spans, and the number of gradient
    evaluations that hold one; ``(0.0, 0)`` without such spans."""
    passes = union(host_spans(events, PASS))
    if not passes:
        return 0.0, 0
    calls = sorted((float(e["ts"]), _correlation(e)) for e in events
                   if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS
                   and _correlation(e) is not None)
    starts = [t for t, _ in calls]
    ids = set()
    for a, b in passes:
        lo, hi = bisect.bisect_left(starts, a), bisect.bisect_right(starts, b)
        ids.update(c for _, c in calls[lo:hi])
    us = sum(float(e["dur"]) for e in events
             if e.get("ph") == "X" and "dur" in e
             and e.get("cat") in DEVICE_CATS and _correlation(e) in ids)
    n = sum(any(a <= p0 and p1 <= b for p0, p1 in passes)
            for a, b in host_spans(events, GRADIENT))
    return us, n


def read(ctx):
    rec = ctx.recorder
    if rec is None or not rec.events:
        return None
    us, n = pass_device(rec.events)
    if not us or not n:
        return None
    return us / n / 1e3
