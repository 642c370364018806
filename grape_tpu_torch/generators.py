"""Time-dependent generators (Hamiltonians and Liouvillians).

Analog of ``QuantumPropagators.Generators`` as consumed by the
reference (``hamiltonian(H0, (H1, ε), …)`` structure, ``README.md:36-42``).
A :class:`Generator` is a drift operator plus a list of ``(operator,
amplitude)`` terms.  For the GRAPE device program it compiles (per list of
trajectories) into stacked dense arrays plus static per-interval coefficient
matrices:

    H_k(ε, n)  =  H0_k + Σ_j  M[n, j, l_j] · ε_{l_j}  ·  Op_{k,j}
    μ_{k,l,n}  =  ∂H_k/∂ε_l = Σ_j M[n, j, l] · Op_{k,j}

where ``M (N_T, T, L)`` holds the (shape-weighted) linear coefficients.  This
keeps the whole time scan free of Python dispatch and makes both ``H`` and
``μ`` batched-matmul workloads.
"""

import numpy as np

from .amplitudes import (
    ComplexAmplitude, CustomAmplitude, LockedAmplitude, ShapedAmplitude,
)

__all__ = [
    "Generator", "hamiltonian", "liouvillian", "align_generators",
    "as_generator",
]


def as_generator(obj):
    """Coerce a plain square matrix into a drift-only :class:`Generator`.

    The reference accepts a static matrix as a (control-free) generator
    (`test/test_empty_optimization.jl`: ``Trajectory(generator =
    random_matrix(N))``); anything already generator-like (has
    ``get_controls``) passes through unchanged.
    """
    if obj is None or hasattr(obj, "get_controls"):
        return obj
    try:
        arr = np.asarray(obj)
    except Exception:
        raise TypeError(
            f"cannot interpret {type(obj).__name__} as a generator: "
            "pass a Generator (e.g. from hamiltonian(H0, (H1, eps), "
            "...)) or a square numeric matrix (drift-only)"
        ) from None
    if (
        arr.ndim == 2 and arr.shape[0] == arr.shape[1]
        and arr.dtype != object
        and np.issubdtype(arr.dtype, np.number)
    ):
        return Generator(arr, [])
    # Anything else is a mistake (e.g. a term list passed where a
    # generator belongs becomes a (T, 2) object array) — fail here with
    # a descriptive error instead of an opaque AttributeError later.
    raise TypeError(
        f"cannot interpret {type(obj).__name__} of shape "
        f"{getattr(arr, 'shape', None)} (dtype {arr.dtype}) as a "
        "generator: pass a Generator (e.g. from hamiltonian(H0, "
        "(H1, eps), ...)) or a square numeric matrix (drift-only)"
    )


class Generator:
    """Drift + control terms: ``H(t) = H0 + Σ_j a_j(ε, t) · Op_j``."""

    def __init__(self, drift, terms):
        self.drift = np.asarray(drift)
        # terms: list of (op, amplitude) where amplitude is a control
        # (callable / vector) or a ShapedAmplitude; ComplexAmplitude terms
        # lower to their two real-quadrature terms
        self.terms = []
        for op, amp in terms:
            if isinstance(amp, ComplexAmplitude):
                self.terms.extend(
                    (np.asarray(o), a) for (o, a) in amp.lower(op)
                )
            else:
                self.terms.append((np.asarray(op), amp))

    def get_controls(self):
        controls = []
        seen = set()
        for _, amp in self.terms:
            amp_controls = (
                amp.get_controls() if hasattr(amp, "get_controls") else (amp,)
            )
            for c in amp_controls:
                if id(c) not in seen:
                    seen.add(id(c))
                    controls.append(c)
        return tuple(controls)

    @property
    def dim(self):
        return self.drift.shape[-1]

    def term_shapes(self, tlist):
        """Per-term static shape values on the intervals: list of ``(N_T,)``
        (``CustomAmplitude`` terms — whose coefficients are traced functions
        of the pulse, not static tables — report ones; they are excluded
        from the linear coefficient tables)."""
        N_T = len(tlist) - 1
        out = []
        for _, amp in self.terms:
            if isinstance(amp, (ShapedAmplitude, LockedAmplitude)):
                out.append(np.asarray(amp.compile(tlist), dtype=np.float64))
            else:
                out.append(np.ones(N_T, dtype=np.float64))
        return out

    def coefficient_tables(self, tlist, controls):
        """``(M (N_T, T, L), Mfix (N_T, T))``: per-interval linear
        coefficients of each term w.r.t. the controls, and the fixed
        (locked-amplitude) coefficients.  ``CustomAmplitude`` (nonlinear)
        terms have all-zero rows here; their coefficients are traced
        closures built by ``compile_problem``."""
        N_T = len(tlist) - 1
        T = len(self.terms)
        L = max(len(controls), 1)
        M = np.zeros((N_T, T, L), dtype=np.float64)
        Mfix = np.zeros((N_T, T), dtype=np.float64)
        shapes = self.term_shapes(tlist)
        for j, l in enumerate(self.term_control_indices(controls)):
            if l is None or isinstance(l, tuple):
                if l is None:
                    Mfix[:, j] = shapes[j]
                # tuple = CustomAmplitude: nonlinear, no static row
            else:
                M[:, j, l] = shapes[j]
        return M, Mfix

    def term_control_indices(self, controls):
        """Index into `controls` for each term's underlying control:
        ``None`` for locked terms (no control), an ``int`` for linear
        terms, a ``tuple`` of ints for ``CustomAmplitude`` (nonlinear)
        terms."""

        def _find(control):
            for l, c in enumerate(controls):
                if c is control:
                    return l
            raise ValueError(
                "term control not found in control list"
            )  # pragma: no cover

        idx = []
        for _, amp in self.terms:
            if isinstance(amp, LockedAmplitude):
                idx.append(None)
            elif isinstance(amp, CustomAmplitude):
                idx.append(tuple(_find(c) for c in amp.controls))
            else:
                control = (
                    amp.control if isinstance(amp, ShapedAmplitude) else amp
                )
                idx.append(_find(control))
        return idx

    def custom_terms(self, controls):
        """``[(j, CustomAmplitude, ctl_indices), ...]`` for the nonlinear
        terms (the reference's general amplitude protocol)."""
        out = []
        for j, (_, amp) in enumerate(self.terms):
            if isinstance(amp, CustomAmplitude):
                idxs = self.term_control_indices(controls)[j]
                out.append((j, amp, idxs))
        return out


def hamiltonian(*parts):
    """Build a :class:`Generator` from drift operators and ``(op, control)``
    tuples, analogous to ``QuantumPropagators.hamiltonian`` (README.md:36-42).

    ``hamiltonian(H0, (H1, eps))``; multiple drift operators are summed; the
    control in a tuple may be a callable ``ε(t)``, a vector of pulse values,
    or a :class:`~grape_tpu_torch.amplitudes.ShapedAmplitude`.
    """
    drift = None
    terms = []
    for part in parts:
        if isinstance(part, tuple) and len(part) == 2:
            op, amp = part
            terms.append((np.asarray(op), amp))
        else:
            op = np.asarray(part)
            drift = op if drift is None else drift + op
    if drift is None:
        if not terms:
            raise ValueError("hamiltonian() needs at least one operator")
        drift = np.zeros_like(terms[0][0])
    return Generator(drift, terms)


def align_generators(generators):
    """Align heterogeneous ensemble generators to a shared term structure.

    The batched evaluation requires every trajectory's generator to have
    the same term list (same count, same amplitude per slot).  This helper
    takes generators whose term lists differ (e.g. a robustness ensemble
    where only some members have a crosstalk drive) and returns new
    :class:`Generator` s over the *union* of all amplitudes, padding missing
    couplings with zero operators.  Coefficient tables, control ordering,
    and gradients are then identical across the ensemble; zero-padded terms
    contribute nothing to ``H_k`` or ``μ_k``.

    Amplitudes are matched by object identity, as controls are
    (``get_controls`` deduplication): ensemble members that share a control
    must reference the *same* amplitude/control object.
    """
    generators = list(generators)
    if not generators:
        return []
    dim = generators[0].dim
    for g in generators:
        if g.dim != dim:
            raise ValueError(
                "align_generators: all generators must have the same "
                f"dimension (got {g.dim} != {dim})"
            )
    # ordered union of amplitude objects across all generators
    union = []
    for g in generators:
        for _, amp in g.terms:
            if not any(amp is u for u in union):
                union.append(amp)
    dtype = np.result_type(
        *(g.drift.dtype for g in generators),
        *(op.dtype for g in generators for (op, _) in g.terms),
    )
    zero = np.zeros((dim, dim), dtype=dtype)
    out = []
    for g in generators:
        terms = []
        for amp in union:
            ops = [op for (op, a) in g.terms if a is amp]
            if not ops:
                terms.append((zero, amp))
            else:
                acc = ops[0].astype(dtype)
                for op in ops[1:]:
                    acc = acc + op
                terms.append((acc, amp))
        out.append(Generator(g.drift, terms))
    return out


def liouvillian(H, c_ops=()):
    """Vectorized Liouvillian ``L`` such that ``dvec(ρ)/dt = -i L vec(ρ)``
    (column stacking), so the same ``exp(-i L dt)`` propagation applies to
    open systems: density matrices are vectorized states to the engine.

    ``H`` may be a :class:`Generator` (terms are lifted term by term) or a
    plain matrix.  ``c_ops`` are static collapse operators (Lindblad).  The
    result is not Hermitian (nor normal) once ``c_ops`` are given: every
    propagator and gradient path of the port takes such generators.
    """
    def _lift_h(op):
        d = op.shape[-1]
        ident = np.eye(d, dtype=complex)
        return np.kron(ident, op) - np.kron(op.T, ident)

    def _lift_c(c):
        d = c.shape[-1]
        ident = np.eye(d, dtype=complex)
        cdc = c.conj().T @ c
        # dρ/dt ⊃ c ρ c† - ½{c†c, ρ}  =>  -i L_c = kron(c*, c) - ½kron(I, c†c)
        #                                       - ½kron((c†c)^T, I)
        return 1j * (
            np.kron(c.conj(), c)
            - 0.5 * np.kron(ident, cdc)
            - 0.5 * np.kron(cdc.T, ident)
        )

    if isinstance(H, Generator):
        drift = _lift_h(H.drift.astype(complex))
        for c in c_ops:
            drift = drift + _lift_c(np.asarray(c, dtype=complex))
        terms = [(_lift_h(op.astype(complex)), amp) for (op, amp) in H.terms]
        return Generator(drift, terms)
    L0 = _lift_h(np.asarray(H, dtype=complex))
    for c in c_ops:
        L0 = L0 + _lift_c(np.asarray(c, dtype=complex))
    return Generator(L0, [])
