"""Shared arithmetic of the per-layer readers: which iterations and spans
lie outside the profiled slice (the profiler's own cost would read as the
program's there), and the device intervals of the slice's trace."""

import re

import numpy as np

__all__ = ["outside_slice", "device_intervals", "union", "kernel_base",
           "slice_span"]


def outside_slice(ctx):
    """``(iteration seconds, span seconds, spans)`` of the iterations whose
    end lies outside the profiled slice, and of the evaluation spans inside
    those iterations."""
    w, rec = ctx.window, ctx.recorder
    lo, hi = rec.slice if (rec is not None and rec.slice) else (None, None)
    starts = [e - s for e, s in zip(w.iter_end, w.iter_s)]
    keep = [not (lo is not None and lo < e <= hi + 1e-9)
            for e in w.iter_end]
    iter_s = [s for s, k in zip(w.iter_s, keep) if k]
    spans = []
    if rec is not None:
        bounds = np.array(w.iter_end)
        for sp in rec.spans:
            j = int(np.searchsorted(bounds, sp[1] - 1e-12))
            if j < len(keep) and keep[j] and sp[0] >= starts[j] - 1e-9:
                spans.append(sp)
    return iter_s, [sp[1] - sp[0] for sp in spans], spans


def kernel_base(name):
    """``propagator_cluster_kernel`` of ``void grape::propagator_cluster_
    kernel<...>(float2 const*, ...)``."""
    head = name.replace("(anonymous namespace)", "anonymous")
    head = head.split("(", 1)[0]
    head = re.sub(r"<.*", "", head)
    head = head.split("::")[-1]
    return head.split()[-1] if head.split() else head


def device_intervals(events):
    """``[(start_us, end_us, name)]`` of the kernels, copies and sets."""
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
             e.get("name", "?"))
            for e in events
            if e.get("ph") == "X" and "dur" in e
            and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def union(intervals):
    """Merged ``[[a, b], ...]`` of ``(a, b, ...)`` intervals."""
    merged = []
    for a, b in sorted((iv[0], iv[1]) for iv in intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def slice_span(events):
    """``(t0, t1)`` in µs: the span of every complete event of the slice."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    if not spans:
        return None
    return (min(float(e["ts"]) for e in spans),
            max(float(e["ts"]) + float(e["dur"]) for e in spans))
