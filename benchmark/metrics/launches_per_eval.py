"""``launches_per_eval``: the host's kernel-launch calls (the CUDA runtime's
``cudaLaunch*`` and the lower-level ``cuLaunch*`` events) that start inside
the port's ``grape.evaluate_*`` spans of the profiled slice, over the
number of those spans.  Reads nothing where the slice holds no such span
or no launch call (the CPU)."""

import bisect

from benchmark.harness.readings import union
from benchmark.metrics.idle_eval import EVALUATIONS, host_spans

CATS = ("cuda_runtime", "cuda_driver")


def read(ctx):
    rec = ctx.recorder
    if rec is None or not rec.events:
        return None
    evals = host_spans(rec.events, EVALUATIONS)
    starts = sorted(float(e["ts"]) for e in rec.events
                    if e.get("ph") == "X" and e.get("cat") in CATS
                    and str(e.get("name", "")).startswith(("cudaLaunch",
                                                           "cuLaunch")))
    if not evals or not starts:
        return None
    inside = sum(bisect.bisect_right(starts, b) - bisect.bisect_left(starts, a)
                 for a, b in union(evals))
    return inside / len(evals)
