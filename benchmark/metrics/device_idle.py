"""``device_idle``: the share of the profiled slice in which no kernel,
copy or set ran on the card: one less the union of their intervals over
the span of every complete event of the slice."""

from benchmark.harness.readings import device_intervals, slice_span, union


def read(ctx):
    rec = ctx.recorder
    if rec is None or not rec.events:
        return None
    merged = union(device_intervals(rec.events))
    span = slice_span(rec.events)
    if not merged or span is None or span[1] <= span[0]:
        return None
    busy = sum(b - a for a, b in merged)
    return (1.0 - busy / (span[1] - span[0])) * 100.0
