"""Pulse shape functions.

Analog of ``QuantumPropagators.Shapes`` (used by the reference at
e.g. ``test/test_tls_optimization.jl:20`` and
``test/test_state_running_cost.jl:219-227``): ``flattop``, ``blackman``,
``box``.

These are *host-side* functions (guess pulses and static shape tables are
discretized on the host before they reach the device), so they compute with
numpy.
"""

import numpy as np

__all__ = ["box", "blackman", "flattop"]


def box(t, t0, T):
    """Box shape: 1.0 for ``t0 <= t <= T``, 0.0 otherwise."""
    t = np.asarray(t)
    return np.where((t >= t0) & (t <= T), 1.0, 0.0)


def blackman(t, t0, T, a=0.16):
    """Blackman window on ``[t0, T]``, zero outside.

    ``0.5 * (1 - a - cos(2π x) + a cos(4π x))`` with ``x = (t - t0)/(T - t0)``.
    """
    t = np.asarray(t)
    x = (t - t0) / (T - t0)
    val = 0.5 * (1.0 - a - np.cos(2 * np.pi * x) + a * np.cos(4 * np.pi * x))
    return np.where((t >= t0) & (t <= T), val, 0.0)


def _sinsq_ramp_up(t, t0, t_rise):
    x = (t - t0) / t_rise
    return np.sin(0.5 * np.pi * x) ** 2


def flattop(t, T, t_rise, t0=0.0, t_fall=None, func="blackman"):
    """Flat shape with a smooth switch-on/off.

    1.0 in ``[t0 + t_rise, T - t_fall]``, ramping from/to zero over ``t_rise``
    (``t_fall``) using a Blackman half-window (``func="blackman"``) or a
    ``sin²`` ramp (``func="sinsq"``); zero outside ``[t0, T]``.
    """
    if t_fall is None:
        t_fall = t_rise
    t = np.asarray(t)
    if func == "blackman":
        up = blackman(t, t0, t0 + 2 * t_rise)
        down = blackman(t, T - 2 * t_fall, T)
    elif func == "sinsq":
        up = _sinsq_ramp_up(t, t0, t_rise)
        down = _sinsq_ramp_up(t, T, -t_fall)
    else:  # pragma: no cover
        raise ValueError(f"Unknown flattop func: {func!r}")
    val = np.where(
        t < t0 + t_rise, up, np.where(t <= T - t_fall, 1.0, down)
    )
    return np.where((t >= t0) & (t <= T), val, 0.0)
