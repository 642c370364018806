"""``idle_loop``: the card's idle time while the host is in the outer
loop's own work and in no evaluation, over the span of the profiled slice:
inside the port's ``grape.setup``, ``grape.lbfgsb``,
``grape.update_result``, ``grape.callback`` or ``grape.finalize`` spans and
outside every ``grape.evaluate_*`` span.  (The port marks
``grape.callback``, around the caller's hooks, only under its own profiler,
so in the benchmark's slice the window's bookkeeping in the callback is the
caller's.)  ``device_idle`` less ``idle_eval`` and ``idle_loop`` is the idle
time under no span of the port's loop (the caller's work, between solves
and in its callback, and the interpreter's glue).  Reads nothing where the
slice holds no such span or no device event."""

from benchmark.harness.readings import union
from benchmark.metrics.idle_eval import (
    EVALUATIONS, host_spans, idle_share, subtract,
)

LOOP = ("grape.setup", "grape.lbfgsb", "grape.update_result",
        "grape.callback", "grape.finalize")


def read(ctx):
    rec = ctx.recorder
    if rec is None or not rec.events:
        return None
    loop = subtract(union(host_spans(rec.events, LOOP)),
                    union(host_spans(rec.events, EVALUATIONS)))
    return idle_share(rec.events, loop)
