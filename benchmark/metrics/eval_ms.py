"""``eval_ms``: the mean of the evaluation spans (the host clock around
``GrapeWrk.evaluate_gradient`` / ``evaluate_functional``, which return J to
the host and so wait for the card)."""

from benchmark.harness.readings import outside_slice


def read(ctx):
    _, span_s, _ = outside_slice(ctx)
    if not span_s:
        return None
    return sum(span_s) / len(span_s) * 1e3
