"""The traced slice in brief: the device operations that took most time,
and the longest idle gaps of the card, each named by what the host was
doing then (the innermost host event around the gap's middle;
``bench.evaluation`` is the program's host work inside an evaluation, and
"host between evaluations" the L-BFGS-B step, the workspace's copies and
the callbacks, which the profiler does not see)."""

from .readings import device_intervals, kernel_base, slice_span, union

__all__ = ["breakdown"]

HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")


def _host_at(events, t):
    best = None
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in HOST_CATS:
            continue
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if a <= t <= b and (best is None or b - a < best[0]):
            best = (b - a, e.get("name", "?"))
    return best[1] if best else "host between evaluations"


def breakdown(events, top=10):
    """``({"device_ops": [[name, s]], "idle_gaps": [[name, s]]}, busy_s,
    window_s)``."""
    dev = device_intervals(events)
    by_name = {}
    for a, b, name in dev:
        key = kernel_base(name)
        by_name[key] = by_name.get(key, 0.0) + (b - a) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    merged = union(dev)
    gaps = sorted(((b0 - a1, a1, b0) for (_, a1), (b0, _) in
                   zip(merged, merged[1:])), reverse=True)[:top]
    idle = [[_host_at(events, 0.5 * (a + b)), g / 1e6] for g, a, b in gaps]
    span = slice_span(events)
    busy = sum(b - a for a, b in merged) / 1e6
    window = (span[1] - span[0]) / 1e6 if span else 0.0
    return ({"device_ops": [[k, v] for k, v in ops], "idle_gaps": idle},
            busy, window)
