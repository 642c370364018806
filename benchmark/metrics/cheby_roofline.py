"""``cheby_roofline``: the Chebyshev scan's bound time over its device time
in the profiled slice.  Each evaluation of the slice is counted at the
term count that its own largest pulse values need (``counts/cheby.py``):
two directions for a gradient evaluation (the forward scan and the
adjoint co-state chain), one for a functional-only evaluation; the device
time is the sum over the launches of the scan's kernels
(``cheby_ring_kernel``, ``cheby_scan_kernel``).  Reads nothing where the
slice holds no evaluation, no launch of those kernels, or a counted
structure without the drift's spectral range."""

from benchmark.counts import cheby, peaks
from benchmark.harness.readings import device_intervals, kernel_base
from benchmark.metrics.taylor_roofline import slice_evaluations

KERNELS = ("cheby_ring_kernel", "cheby_scan_kernel")
DIRECTIONS = {"evaluate_gradient": 2, "evaluate_functional": 1}


def read(ctx):
    rec = ctx.recorder
    st = ctx.structure
    if rec is None or not rec.events or "h0_range" not in st:
        return None
    us = sum(b - a for a, b, name in device_intervals(rec.events)
             if kernel_base(name) in KERNELS)
    evals = slice_evaluations(ctx)
    if not us or not evals:
        return None
    bound_ms = sum(DIRECTIONS.get(kind, 0)
                   * peaks.bound(*cheby.direction(st, amps))[0]
                   for _, _, kind, amps in evals)
    return bound_ms / (us / 1e3) * 100.0
