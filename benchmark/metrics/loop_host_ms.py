"""``loop_host_ms``: the host's time an iteration outside the evaluations
(the L-BFGS-B step, the workspace's copies, the callbacks, and a solve's
set-up on its first iteration): the iterations' wall time less the
evaluation spans inside them, over the iterations."""

from benchmark.harness.readings import outside_slice


def read(ctx):
    iter_s, span_s, _ = outside_slice(ctx)
    if not iter_s or not span_s:
        return None
    return (sum(iter_s) - sum(span_s)) / len(iter_s) * 1e3
