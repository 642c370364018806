"""Control discretization.

Analog of ``QuantumPropagators.Controls`` as consumed by the
reference front end (``src/workspace.jl:154-162``,
``src/result.jl:76``, ``src/optimize.jl:226``):

- a *control* is either a Python callable ``eps(t) -> float`` or a 1D array of
  values (on the time-grid points, length ``N_T + 1``, or on the interval
  midpoints, length ``N_T``);
- ``discretize_on_midpoints(control, tlist)`` produces the vector of ``N_T``
  pulse values on the intervals (first/last "midpoints" are ``t=0``/``t=T``);
- ``discretize(control, tlist)`` produces ``N_T + 1`` values on the grid
  points.  For vector controls, the two are exact inverses of each other
  (endpoint-preserving midpoint/point averaging), matching the reference's
  round-trip guarantee used in ``finalize_result!``.
"""

import numpy as np

__all__ = ["discretize", "discretize_on_midpoints", "midpoints", "get_controls"]


def midpoints(tlist):
    """Interval 'midpoints' with endpoint convention: [t0, mid..., T]."""
    tlist = np.asarray(tlist, dtype=np.float64)
    mid = 0.5 * (tlist[1:] + tlist[:-1])
    mid[0] = tlist[0]
    mid[-1] = tlist[-1]
    return mid


def discretize(control, tlist):
    """Values of `control` on the points of `tlist` (length ``N_T + 1``)."""
    tlist = np.asarray(tlist, dtype=np.float64)
    N = len(tlist)
    if callable(control):
        return np.array([float(control(t)) for t in tlist], dtype=np.float64)
    vals = np.asarray(control, dtype=np.float64)
    if len(vals) == N:
        return vals.copy()
    if len(vals) == N - 1:  # midpoint values -> point values
        out = np.empty(N, dtype=np.float64)
        out[0] = vals[0]
        out[-1] = vals[-1]
        out[1:-1] = 0.5 * (vals[:-1] + vals[1:])
        return out
    raise ValueError(
        f"control array of length {len(vals)} incompatible with tlist of length {N}"
    )


def discretize_on_midpoints(control, tlist):
    """Values of `control` on the ``N_T`` intervals of `tlist`.

    The value for the first (last) interval is taken at ``t=0`` (``t=T``),
    matching the reference convention (``docs/src/background.md``: H is
    "evaluated at the midpoint of the n'th interval, respectively at t=0 and
    t=T for n=1 and n=N_T").
    """
    tlist = np.asarray(tlist, dtype=np.float64)
    N = len(tlist)
    if callable(control):
        return np.array(
            [float(control(t)) for t in midpoints(tlist)], dtype=np.float64
        )
    vals = np.asarray(control, dtype=np.float64)
    if len(vals) == N - 1:
        return vals.copy()
    if len(vals) == N:  # point values -> midpoint values (inverse of discretize)
        out = np.empty(N - 1, dtype=np.float64)
        out[0] = vals[0]
        out[-1] = vals[-1]
        # exact inverse of the averaging in `discretize`:
        #   pts[i] = 0.5*(mid[i-1] + mid[i])  =>  mid[i] = 2*pts[i] - mid[i-1]
        for i in range(1, N - 2):
            out[i] = 2.0 * vals[i] - out[i - 1]
        return out
    raise ValueError(
        f"control array of length {len(vals)} incompatible with tlist of length {N}"
    )


def get_controls(generators):
    """Distinct controls (by object identity) across one or more generators.

    Analog of ``QuantumPropagators.Controls.get_controls`` as used at
    ``src/workspace.jl:154``.  Order of first appearance is
    preserved.
    """
    from .generators import Generator

    if not isinstance(generators, (list, tuple)):
        generators = [generators]
    controls = []
    seen = set()
    for gen in generators:
        if isinstance(gen, Generator):
            gen_controls = gen.get_controls()
        elif hasattr(gen, "get_controls"):
            gen_controls = gen.get_controls()
        else:
            gen_controls = ()
        for c in gen_controls:
            if id(c) not in seen:
                seen.add(id(c))
                controls.append(c)
    return tuple(controls)
