"""``dispatch_ms``: the mean of the port's ``grape.dispatch`` spans in the
profiled slice: the host's call of an evaluation's program, which enqueues
its work on the card and returns device tensors (plus any wait that the
program itself forces).  Against ``eval_ms`` it says how much of an
evaluation the host spends launching.  Reads nothing where the slice holds
no such span."""

from benchmark.metrics.idle_eval import host_spans


def read(ctx):
    rec = ctx.recorder
    if rec is None or not rec.events:
        return None
    spans = host_spans(rec.events, ("grape.dispatch",))
    if not spans:
        return None
    return sum(b - a for a, b in spans) / len(spans) / 1e3
