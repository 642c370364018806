"""``eval_mfu_cheby``: the float32 operations that the window's evaluations
need under Chebyshev propagation and the time-vectorized Taylor gradient,
over their span time at the float32 peak: for every evaluation the forward
Chebyshev scan, and for a gradient evaluation also the adjoint co-state
scan and the Taylor pass, each at the term or order count that the
evaluation's own largest pulse values need (``counts/cheby.py``,
``counts/envelope.taylor_orders``).  No propagator is formed on this
path, so none is counted.  Like ``eval_mfu``, from the evaluations outside
the profiled slice.  Reads nothing where the counted structure has no
spectral range of the drift."""

from benchmark.counts import cheby, peaks, taylor
from benchmark.harness.readings import outside_slice
from benchmark.metrics.cheby_roofline import DIRECTIONS
from benchmark.metrics.taylor_roofline import orders


def read(ctx):
    st = ctx.structure
    if "h0_range" not in st:
        return None
    _, span_s, spans = outside_slice(ctx)
    if not spans:
        return None
    total = 0.0
    for _, _, kind, amps in spans:
        total += DIRECTIONS.get(kind, 0) * cheby.direction(st, amps)[0]
        if kind == "evaluate_gradient":
            m = orders(st, amps)
            if m is None:
                return None
            total += taylor.pass_flops(st["d"], st["K"], st["L"], st["N_T"],
                                       m)
    return total / (sum(span_s) * peaks.PEAK_FP32_FLOPS) * 100.0
