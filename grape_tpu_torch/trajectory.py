"""Trajectories and control problems.

Analog of ``QuantumControl.Trajectory`` / ``QuantumControl.ControlProblem`` as
consumed by the reference (``src/workspace.jl:8,153,243,366-368``).
A :class:`Trajectory` bundles an initial state with a dynamical generator and
arbitrary extra attributes (``target_state``, ``weight``, …).  A
:class:`ControlProblem` bundles trajectories, the time grid, and default
keyword arguments for :func:`grape_tpu_torch.optimize`.
"""

import numpy as np

__all__ = ["Trajectory", "ControlProblem"]


class Trajectory:
    """One trajectory: ``initial_state`` evolving under ``generator``.

    Extra keyword arguments (e.g. ``target_state``, ``weight``) are stored as
    attributes and available to functionals; ``kwargs`` keeps the raw dict
    (mirroring the reference's ``getfield(traj, :kwargs)``).
    """

    def __init__(self, initial_state, generator, **kwargs):
        self.initial_state = np.asarray(initial_state)
        from .generators import as_generator

        self.generator = as_generator(generator)
        self.kwargs = dict(kwargs)
        self.target_state = kwargs.pop("target_state", None)
        if self.target_state is not None:
            self.target_state = np.asarray(self.target_state)
        self.weight = kwargs.pop("weight", 1.0)
        for key, val in kwargs.items():
            setattr(self, key, val)

    def __repr__(self):
        extra = ", ".join(sorted(self.kwargs))
        return f"Trajectory(dim={len(self.initial_state)}{', ' + extra if extra else ''})"


class ControlProblem:
    """A full control problem: trajectories + time grid + default kwargs."""

    def __init__(self, trajectories, tlist, **kwargs):
        self.trajectories = list(trajectories)
        self.tlist = np.asarray(tlist, dtype=np.float64)
        self.kwargs = dict(kwargs)
