"""``collective_ms``: the device time of the collectives' kernels (the
slice's device events whose kernel is named ``nccl*``) on rank 0's card,
over the port's ``grape.evaluate_*`` spans in the profiled slice: per
evaluation, the two all-reduces of ``parallel/mesh.py`` ``_TrajReduce``.
A collective's kernel runs until the slowest rank has joined, so this
reads the transfer and the ranks' skew together.  Reads nothing where the
slice holds no such kernel (one card) or no such span."""

from benchmark.harness.readings import device_intervals, kernel_base
from benchmark.metrics.idle_eval import EVALUATIONS, host_spans


def read(ctx):
    rec = ctx.recorder
    if rec is None or not rec.events:
        return None
    us = sum(b - a for a, b, name in device_intervals(rec.events)
             if kernel_base(name).startswith("nccl"))
    evals = host_spans(rec.events, EVALUATIONS)
    if not us or not evals:
        return None
    return us / len(evals) / 1e3
