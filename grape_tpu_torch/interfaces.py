"""Input validation.

Analog of ``QuantumPropagators.Interfaces`` / the reference wrapper's
``check=true`` validation (``check_state`` / ``check_generator``, used at
``test/test_tls_optimization.jl:9,100``): verify that states and generators
satisfy the interface the engine expects, with actionable error messages.
"""

import numpy as np

from .controls import get_controls
from .generators import Generator

__all__ = ["check_state", "check_generator", "check_problem"]


def check_state(state, normalized=False):
    """A state is a complex vector of finite entries (optionally normalized)."""
    state = np.asarray(state)
    if state.ndim != 1:
        raise ValueError(
            f"state must be a vector, got shape {state.shape}"
        )
    if not (np.all(np.isfinite(np.real(state)))
            and np.all(np.isfinite(np.imag(state)))):
        raise ValueError("state contains non-finite entries")
    if normalized:
        nrm = np.linalg.norm(state)
        if abs(nrm - 1.0) > 1e-10:
            raise ValueError(f"state is not normalized: ||ψ|| = {nrm}")
    return True


def check_generator(generator, state=None, tlist=None):
    """A generator is a :class:`Generator` with square operators of a
    consistent dimension matching the state."""
    if not isinstance(generator, Generator):
        raise TypeError(
            f"generator must be a grape_tpu_torch Generator (build it with "
            f"hamiltonian(...) or liouvillian(...)), got {type(generator)}"
        )
    d = generator.dim
    if generator.drift.shape != (d, d):
        raise ValueError(
            f"drift operator must be square, got {generator.drift.shape}"
        )
    for j, (op, _) in enumerate(generator.terms):
        if op.shape != (d, d):
            raise ValueError(
                f"control operator {j} has shape {op.shape}, expected "
                f"({d}, {d})"
            )
    if state is not None:
        state = np.asarray(state)
        if state.shape != (d,):
            raise ValueError(
                f"state dimension {state.shape} does not match generator "
                f"dimension {d}"
            )
    if tlist is not None:
        tlist = np.asarray(tlist)
        if len(tlist) < 2:
            raise ValueError("tlist must have at least 2 points")
        if np.any(np.diff(tlist) <= 0):
            raise ValueError("tlist must be strictly increasing")
        for control in get_controls(generator):
            if not callable(control):
                vals = np.asarray(control)
                if len(vals) not in (len(tlist), len(tlist) - 1):
                    raise ValueError(
                        f"control vector of length {len(vals)} is "
                        f"incompatible with tlist of length {len(tlist)}"
                    )
    return True


def check_problem(trajectories, tlist):
    """Validate a full problem (the reference wrapper's ``check=true``)."""
    for k, traj in enumerate(trajectories):
        try:
            check_state(traj.initial_state)
            check_generator(traj.generator, traj.initial_state, tlist)
            if traj.target_state is not None:
                check_state(traj.target_state)
                if len(np.asarray(traj.target_state)) != len(
                    np.asarray(traj.initial_state)
                ):
                    raise ValueError(
                        "target_state dimension does not match initial_state"
                    )
        except (ValueError, TypeError) as exc:
            raise type(exc)(f"trajectory {k}: {exc}") from None
    return True
