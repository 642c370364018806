"""``kernel_roofline``: the hand-written kernels' bound time over their
device time in the profiled slice.  Each call of a launch wrapper while
the profiler ran is counted at its own shapes and squaring count
(``benchmark/counts``); the device time is the sum over the launches of
the kernels of those wrappers.  Reads nothing where a wrapper's calls and
its kernels' launches do not both appear."""

from benchmark.counts import frechet, peaks, propagators, state_scan
from benchmark.harness.readings import device_intervals, kernel_base

COUNTS = {"propagators": propagators, "state_scan": state_scan,
          "frechet": frechet}
# the kernels each launch wrapper runs, by base name
KERNELS = {
    "propagators": ("propagator_cluster_kernel", "propagator_kernel",
                    "wide_generator_kernel", "wide_product_big_kernel",
                    "wide_product_mid_kernel"),
    "state_scan": ("state_scan_kernel", "state_grid_kernel",
                   "chi_scan_kernel", "forward_apply_kernel"),
    "frechet": ("frechet_factored_kernel", "frechet_trace_kernel"),
}


def read(ctx):
    rec = ctx.recorder
    if rec is None or not rec.events:
        return None
    family = {k: f for f, names in KERNELS.items() for k in names}
    device_us = {f: 0.0 for f in KERNELS}
    launched = set()
    for a, b, name in device_intervals(rec.events):
        f = family.get(kernel_base(name))
        if f is not None:
            device_us[f] += b - a
            launched.add(f)
    bound_ms = {f: 0.0 for f in KERNELS}
    called = set()
    for kind, shape in rec.kernel_calls:
        if shape is None:
            return None
        fl, by = COUNTS[kind].of_call(shape)
        bound_ms[kind] += peaks.bound(fl, by)[0]
        called.add(kind)
    if not launched or launched != called:
        return None
    return (sum(bound_ms.values()) / (sum(device_us.values()) / 1e3)
            * 100.0)
