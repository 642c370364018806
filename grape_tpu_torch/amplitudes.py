"""Control amplitudes.

Analog of ``QuantumPropagators.Amplitudes`` as used by the reference
(``ShapedAmplitude`` at ``test/test_lbfgsb_saddle_point.jl:9,59-63``
and ``docs/src/tutorial.md:77-108``): an *amplitude* maps the value of an
underlying control ``ε_l(t)`` to the coefficient ``a(ε, t)`` multiplying a
Hamiltonian term.  The optimization always acts on the control values; the
amplitude (and its derivative ``∂a/∂ε``) enters the Hamiltonian evaluation and
the control-derivative operators ``μ_l = ∂H/∂ε_l``.

For the device program, each amplitude is compiled to a pair of static
per-interval arrays / closures via :meth:`compile` — no Python dispatch inside
the time scan.
"""

import numpy as np

from .controls import discretize_on_midpoints

__all__ = [
    "ShapedAmplitude", "LockedAmplitude", "ComplexAmplitude",
    "CustomAmplitude",
]


class LockedAmplitude:
    """A fixed (non-optimized) time-dependent amplitude ``a(t) = shape(t)``.

    Analog of ``QuantumPropagators.Amplitudes.LockedAmplitude``: the term
    contributes shape(t)·Op to the generator but exposes no control, so the
    optimization never touches it (e.g. a fixed pump pulse while optimizing
    the Stokes pulse).
    """

    def __init__(self, shape):
        self.shape = shape

    def get_controls(self):
        return ()

    def compile(self, tlist):
        return discretize_on_midpoints(self.shape, tlist)


class ShapedAmplitude:
    """Amplitude ``a(t) = shape(t) * ε(t)`` for a control ``ε``.

    ``shape`` is a static function of time (or a vector on the time grid /
    midpoints); ``control`` is the optimizable control.  The derivative
    ``∂a/∂ε`` at interval ``n`` is ``shape(t_n)``.
    """

    def __init__(self, control, shape):
        self.control = control
        self.shape = shape

    def get_controls(self):
        return (self.control,)

    def compile(self, tlist):
        """Static per-interval shape values ``(N_T,)``."""
        return discretize_on_midpoints(self.shape, tlist)


class CustomAmplitude:
    """General (nonlinear) amplitude ``a(ε, t)``.

    The reference evaluates control-derivative operators per step with the
    current pulse values (``get_control_derivs`` at
    ``src/workspace.jl:285-286``, consumed with
    ``evaluate(μ; vals_dict)`` at ``src/optimize.jl:946-957``), so
    amplitudes may depend nonlinearly on the control — e.g. ``a = ε²`` or
    trig-bounded parametrizations ``a = A·sin(ε)``.  The coefficient and
    its control derivative are evaluated per interval from the current
    pulse values inside each evaluation (``torch.func.vmap`` over the time
    grid), so gradients pick up the chain-rule factor ``∂a/∂ε`` exactly;
    the kernels consume the resulting coefficient tables as for linear
    amplitudes.

    Parameters
    ----------
    func:
        ``func(vals, t) -> coefficient`` — real-valued, written in torch
        operations (it is mapped with ``torch.func.vmap`` and
        differentiated with ``torch.func.jacfwd``).
        ``vals`` is the ``(n,)`` vector of this amplitude's control values
        at time ``t`` (a scalar for a single control works via ``vals[0]``).
    controls:
        The underlying control(s) — a single control or a tuple.
    deriv:
        Optional ``deriv(vals, t) -> (n,)`` gradient ``∂a/∂ε``; defaults
        to forward-mode AD (``torch.func.jacfwd``) of ``func``.
    bound:
        Optional host-side envelope callback
        ``bound(amp_max (n,)) -> (max_abs_a, max_abs_da (n,))`` giving the
        maximum of ``|a|`` and ``|∂a/∂ε_i|`` over the pulse box
        ``|ε_i| ≤ amp_max_i`` (all t).  Without it the envelope is
        estimated by sampling the box (with a safety margin); supply an
        analytic bound for amplitudes whose extrema a coarse grid could
        miss.
    """

    def __init__(self, func, controls, deriv=None, bound=None):
        self.func = func
        if isinstance(controls, (tuple, list)):
            self.controls = tuple(controls)
        else:
            self.controls = (controls,)
        if not self.controls:
            raise ValueError(
                "CustomAmplitude needs at least one control (use "
                "LockedAmplitude for fixed time-dependent coefficients)"
            )
        self.deriv = deriv
        self.bound = bound

    def get_controls(self):
        return self.controls


class ComplexAmplitude:
    """Complex amplitude ``a(t) = ε_re(t) + i·ε_im(t)`` from two real
    controls (analog of ``QuantumPropagators.Amplitudes.ComplexAmplitude``).

    The two quadratures are independent optimizable controls (each may also
    be a :class:`ShapedAmplitude` or :class:`LockedAmplitude`).  Inside
    :class:`~grape_tpu_torch.generators.Generator`, a term ``(Op,
    ComplexAmplitude(re, im))`` lowers to the two real-coefficient terms
    ``(Op, re)`` and ``(i·Op, im)``, so the gradient machinery sees plain
    real controls with exact control derivatives ``μ_re = Op``,
    ``μ_im = i·Op`` — the same two-quadrature encoding the reference's CNOT
    test writes out by hand (``test/test_lbfgsb_saddle_point.jl``:
    independent ``σx``/``σy`` drive terms).
    """

    def __init__(self, re, im, _im_sign=1.0):
        self.re = re
        self.im = im
        self._im_sign = float(_im_sign)

    def conjugate(self):
        """The conjugate amplitude ``a*(t) = ε_re(t) - i·ε_im(t)``, sharing
        the same underlying controls — so Hermitian generators like
        ``Ω(t)·σ₋ + Ω*(t)·σ₊`` are written as two terms over one pair of
        quadrature controls."""
        return ComplexAmplitude(self.re, self.im, _im_sign=-self._im_sign)

    conj = conjugate

    def get_controls(self):
        controls = []
        for part in (self.re, self.im):
            part_controls = (
                part.get_controls()
                if hasattr(part, "get_controls")
                else (part,)
            )
            for c in part_controls:
                if not any(c is seen for seen in controls):
                    controls.append(c)
        return tuple(controls)

    def lower(self, op):
        """The two real-quadrature terms ``[(op, re), (±i·op, im)]``."""
        op = np.asarray(op)
        return [
            (op, self.re),
            (self._im_sign * 1j * op.astype(complex), self.im),
        ]
