"""``eval_mfu``: the float32 operations that the window's evaluations need,
over their span time at the float32 peak.  Each evaluation is counted by
the cell's algorithm at the squaring count (and, for the Taylor series, the
order count) that its own pulse needs; the forward propagators once."""

from benchmark.counts import envelope, gradgen, peaks, taylor
from benchmark.harness.readings import outside_slice


def read(ctx):
    _, span_s, spans = outside_slice(ctx)
    if not spans:
        return None
    st = ctx.structure
    method = ctx.traffic["options"].get("gradient_method", "gradgen")
    total = 0.0
    for _, _, _, amps in spans:
        norm = envelope.step_norm(st["dt"], st["h0_norm"], st["op_norms"],
                                  amps)
        s = envelope.squarings(norm)
        if method == "gradgen":
            total += gradgen.evaluation_flops(st["d"], st["G"], st["gs"],
                                              st["T"], st["N_T"], s)
        elif method == "taylor":
            orders = envelope.taylor_orders(
                norm, max(st["op_norms"]) / max(norm / st["dt"], 1e-30))
            if orders is None:
                return None
            total += taylor.evaluation_flops(st["d"], st["G"], st["gs"],
                                             st["L"], st["N_T"], s, orders)
        else:
            return None
    return total / (sum(span_s) * peaks.PEAK_FP32_FLOPS) * 100.0
