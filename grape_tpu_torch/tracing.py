"""Named spans of the optimization on the profiler's timeline.

``span(name)`` marks a stretch of the host's work (the solve, its set-up,
each L-BFGS-B step, each evaluation and its stages) as a
``torch.profiler.record_function`` range, so that it lands in the same
Chrome trace as the card's kernels and copies, on the same clock.  A gap in
which the card is idle is then named by the innermost span around it.

The profiler is the one sink: a span exists exactly while a
``torch.profiler`` records, which is ``optimize(..., profile_dir=...)`` or a
profiler that the caller runs around a solve.  With no profiler running,
``span`` returns a shared context that does nothing, after one check of the
profiler's flag (a fraction of a microsecond), so an untraced solve pays
next to nothing for its spans.  A span entered before the profiler starts
leaves no event.  Spans never touch the card: the arithmetic and the
launches are the same with the profiler on or off.

A range still open when the profiler stops is exported with the end of the
profiler's own post-processing, well after the stop (tens to hundreds of
milliseconds on an H100 with a busy trace), which would stretch the traced
window.  A caller may stop its profiler in its own hooks (``callback``,
``check_convergence``), so the two spans that enclose them, ``grape.solve``
and ``grape.callback``, are marked only under the port's own profiler
(``profile_dir``), which stops after the solve; under a caller's profiler the
solve shows as its parts.

Every name starts with ``grape.``:

- the outer loop: ``grape.solve`` and ``grape.callback`` (under
  ``profile_dir``), ``grape.setup``, ``grape.lbfgsb``,
  ``grape.update_result``, ``grape.finalize``;
- an evaluation: ``grape.evaluate_gradient`` / ``grape.evaluate_functional``,
  and in them ``grape.envelope`` (with ``grape.build_programs`` when a new
  envelope bucket's programs are built), ``grape.dispatch`` (the host
  enqueueing the evaluation's work) and ``grape.readback`` (the reads of
  its results, where the host waits for the card);
- the stages inside ``grape.dispatch``: ``grape.coefficients``,
  ``grape.forward``, ``grape.boundary``, ``grape.backward`` (with one
  ``grape.segment`` per recompute segment) and ``grape.assemble``;
- inside ``grape.backward`` (or its segment), for a window whose co-states
  are chained apart from the gradient: ``grape.costates`` (the co-state
  chain: the χ scans, or the adjoint Chebyshev scan) and
  ``grape.taylor_pass`` (the time-vectorized Taylor pass).
"""

import contextlib

import torch
from torch.autograd import profiler as _profiler

__all__ = ["span", "profiling", "own_profiler"]

_OFF = contextlib.nullcontext()
_own = False  # the port's own profiler (profile_dir) records

if hasattr(_profiler, "_is_profiler_enabled"):
    def profiling():
        """True while a ``torch.profiler`` records on this process."""
        return _profiler._is_profiler_enabled
else:
    profiling = torch._C._autograd._profiler_enabled


def span(name, hooks=False):
    """A context that marks its body as the profiler range ``name`` while
    a profiler records, and does nothing otherwise.  ``hooks``: the body
    runs the caller's hooks, so the range is marked only under the port's
    own profiler."""
    if profiling() and (_own or not hooks):
        return _profiler.record_function(name)
    return _OFF


@contextlib.contextmanager
def own_profiler():
    """The body runs under the port's own profiler, which stops only after
    it: spans around the caller's hooks are marked too."""
    global _own
    outer, _own = _own, True
    try:
        yield
    finally:
        _own = outer
