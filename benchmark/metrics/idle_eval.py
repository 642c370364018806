"""``idle_eval``: the card's idle time while the host is inside an
evaluation (the port's ``grape.evaluate_gradient`` /
``grape.evaluate_functional`` spans), over the span of the profiled slice:
the host's own work in an evaluation that the card waits for (the launches
of a pass run from Python, the envelope check, the copies after the
results).  Also the arithmetic on the port's spans that the other span
readers share.  Reads nothing where the slice holds no such span (a program
without them) or no device event (the CPU)."""

from benchmark.harness.readings import device_intervals, slice_span, union

EVALUATIONS = ("grape.evaluate_gradient", "grape.evaluate_functional")


def host_spans(events, names):
    """``[(start_us, end_us)]`` of the host's ranges named in ``names``
    (``user_annotation`` events; the profiler also draws each range's
    kernels on the card's timeline as a ``gpu_user_annotation`` of the same
    name, which is not the host's time), in trace order, less those whose
    end reaches the trace's last end: spans still open when the profiler
    stopped, which it exports clipped there."""
    span = slice_span(events)
    if span is None:
        return []
    out = []
    for e in events:
        if (e.get("ph") == "X" and "dur" in e
                and e.get("cat") == "user_annotation"
                and e.get("name") in names):
            a = float(e["ts"])
            b = a + float(e["dur"])
            if b < span[1]:
                out.append((a, b))
    return out


def overlap(xs, ys):
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a = max(xs[i][0], ys[j][0])
        b = min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def subtract(xs, ys):
    """``xs`` less ``ys``, both sorted lists of disjoint intervals."""
    out = []
    for a, b in xs:
        for c, d in ys:
            if d <= a or c >= b:
                continue
            if c > a:
                out.append([a, c])
            a = max(a, d)
            if a >= b:
                break
        if a < b:
            out.append([a, b])
    return out


def idle_share(events, intervals):
    """The card's idle time inside ``intervals`` (sorted, disjoint) over
    the slice's span, in %; None without device events or intervals."""
    busy = union(device_intervals(events))
    span = slice_span(events)
    if not busy or not intervals or span is None or span[1] <= span[0]:
        return None
    idle = sum(b - a for a, b in intervals) - overlap(intervals, busy)
    return idle / (span[1] - span[0]) * 100.0


def read(ctx):
    rec = ctx.recorder
    if rec is None or not rec.events:
        return None
    return idle_share(rec.events, union(host_spans(rec.events, EVALUATIONS)))
