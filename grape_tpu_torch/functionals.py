"""Optimization functionals and semi-automatic differentiation.

Counterpart of ``grape_tpu/functionals.py`` (itself the analog of
``QuantumControl.Functionals``): the standard final-time functionals
``J_T_sm`` / ``J_T_re`` / ``J_T_ss`` with their analytic ``chi``
counterparts, the pulse running cost ``J_a_fluence``, the state running
cost ``J_b``, the gate and ensemble-gate functionals, and the semi-AD
constructors ``make_chi`` / ``make_grad_J_a`` / ``make_gate_chi`` on
``torch.autograd`` and ``make_xi`` on ``torch.func``.

Conventions: the co-state is

    |χ_k(T)⟩ = -∂J_T/∂⟨Ψ_k(T)| = -∂J_T/∂Ψ_k* .

For a real function of a complex tensor, ``torch.autograd`` returns
``∂J/∂Re[z] + i ∂J/∂Im[z] = 2 ∂J/∂z*``, so ``χ = -½ Ψ.grad`` with NO
conjugation.  (``jax.grad`` returns the conjugate of that, which is why the
JAX package has ``χ = -½ conj(g)``.)  The same holds for the running-cost
source ``ξ = -½ ∇_Ψ g_b`` of :func:`make_xi`.

**Batched API**: functionals receive the stacked final states ``Psi (K, d)``
(torch tensor), the list of :class:`~grape_tpu_torch.trajectory.Trajectory`
objects (static), and optionally ``tau (K,)`` — the overlaps
``τ_k = ⟨Ψ_k^tgt|Ψ_k(T)⟩`` — via keyword.
"""

import inspect

import numpy as np
import torch

from .config import real_dtype

__all__ = [
    "J_T_sm", "J_T_re", "J_T_ss", "F_sm", "F_re", "F_ss",
    "chi_sm", "chi_re", "chi_ss",
    "J_a_fluence", "grad_J_a_fluence", "J_b", "grid_weights",
    "make_chi", "make_grad_J_a", "make_analytic_chi", "make_xi",
    "make_ensemble_gate_functional", "gate_functional", "make_gate_chi",
    "taus", "weights_of", "accepts_tau", "set_default_ad_framework",
]

_ANALYTIC_CHI = {}


def weights_of(trajectories, like):
    """Trajectory weights ``(K,)`` as a real tensor on the device, and of
    the precision, of the tensor ``like``."""
    w = np.asarray([getattr(t, "weight", 1.0) for t in trajectories],
                   dtype=np.float64)
    return torch.as_tensor(w, dtype=real_dtype(like.dtype),
                           device=like.device)


def _targets(trajectories, like):
    tgt = np.stack([np.asarray(t.target_state) for t in trajectories])
    return torch.as_tensor(tgt, dtype=like.dtype, device=like.device)


def taus(Psi, trajectories):
    """Overlaps ``τ_k = ⟨Ψ_k^tgt | Ψ_k⟩`` for stacked states ``Psi (K, d)``."""
    tgt = _targets(trajectories, Psi)
    return torch.sum(torch.conj(tgt) * Psi, dim=-1)


# --------------------------------------------------------------------------
# Standard final-time functionals
# --------------------------------------------------------------------------

def J_T_sm(Psi, trajectories, tau=None):
    """Square-modulus functional ``1 - |Σ_k w_k τ_k|² / K²``."""
    if tau is None:
        tau = taus(Psi, trajectories)
    w = weights_of(trajectories, tau)
    K = len(trajectories)
    f = torch.sum(w * tau)
    return 1.0 - torch.abs(f) ** 2 / K**2


def chi_sm(Psi, trajectories, tau=None):
    """Analytic ``χ_k = (Σ_j w_j τ_j / K²) w_k |Ψ_k^tgt⟩`` for `J_T_sm`."""
    if tau is None:
        tau = taus(Psi, trajectories)
    w = weights_of(trajectories, tau)
    K = len(trajectories)
    f = torch.sum(w * tau)
    tgt = _targets(trajectories, Psi)
    return (f / K**2) * (w[:, None] * tgt)


def J_T_re(Psi, trajectories, tau=None):
    """Real-part functional ``1 - Re[Σ_k w_k τ_k] / K``."""
    if tau is None:
        tau = taus(Psi, trajectories)
    w = weights_of(trajectories, tau)
    K = len(trajectories)
    return 1.0 - torch.real(torch.sum(w * tau)) / K


def chi_re(Psi, trajectories, tau=None):
    """Analytic ``χ_k = w_k |Ψ_k^tgt⟩ / (2K)`` for `J_T_re`."""
    K = len(trajectories)
    w = weights_of(trajectories, Psi)
    tgt = _targets(trajectories, Psi)
    return (w[:, None] / (2 * K)) * tgt


def J_T_ss(Psi, trajectories, tau=None):
    """State-to-state functional ``1 - Σ_k w_k |τ_k|² / K``."""
    if tau is None:
        tau = taus(Psi, trajectories)
    w = weights_of(trajectories, tau)
    K = len(trajectories)
    return 1.0 - torch.sum(w * torch.abs(tau) ** 2) / K


def chi_ss(Psi, trajectories, tau=None):
    """Analytic ``χ_k = (w_k/K) τ_k |Ψ_k^tgt⟩`` for `J_T_ss`."""
    if tau is None:
        tau = taus(Psi, trajectories)
    w = weights_of(trajectories, tau)
    K = len(trajectories)
    tgt = _targets(trajectories, Psi)
    return (w * tau / K)[:, None] * tgt


_ANALYTIC_CHI[J_T_sm] = chi_sm
_ANALYTIC_CHI[J_T_re] = chi_re
_ANALYTIC_CHI[J_T_ss] = chi_ss


def F_sm(Psi, trajectories, tau=None):
    """Square-modulus fidelity ``1 - J_T_sm``."""
    return 1.0 - J_T_sm(Psi, trajectories, tau=tau)


def F_re(Psi, trajectories, tau=None):
    """Real-part fidelity ``1 - J_T_re``."""
    return 1.0 - J_T_re(Psi, trajectories, tau=tau)


def F_ss(Psi, trajectories, tau=None):
    """State-to-state fidelity ``1 - J_T_ss``."""
    return 1.0 - J_T_ss(Psi, trajectories, tau=tau)


# --------------------------------------------------------------------------
# Pulse running costs
# --------------------------------------------------------------------------

def _dt_like(tlist, like):
    tl = torch.as_tensor(tlist, dtype=like.dtype, device=like.device)
    return torch.diff(tl)


def J_a_fluence(pulsevals, tlist):
    """Fluence ``Σ_{nl} ε_{nl}² dt_n`` (pulsevals ``(L, N_T)`` or flat)."""
    pulsevals = torch.as_tensor(pulsevals)
    dt = _dt_like(tlist, pulsevals)
    eps = torch.reshape(pulsevals, (-1, dt.shape[0]))
    return torch.sum(eps**2 * dt[None, :])


def grad_J_a_fluence(pulsevals, tlist):
    pulsevals = torch.as_tensor(pulsevals)
    dt = _dt_like(tlist, pulsevals)
    eps = torch.reshape(pulsevals, (-1, dt.shape[0]))
    return torch.reshape(2.0 * eps * dt[None, :], pulsevals.shape)


def grid_weights(tlist):
    """Trapezoid weights over the grid points of ``tlist (N_T+1,)`` (a
    tensor): ``[dt_1/2, Δt_1.., dt_NT/2]`` with
    ``Δt_n = (t_{n+1} - t_{n-1})/2``."""
    dt = torch.diff(tlist)
    return torch.cat([0.5 * dt[:1], 0.5 * (dt[:-1] + dt[1:]), 0.5 * dt[-1:]])


def running_cost_values(g_b, states, trajectories, tlist, n0=0):
    """``g_b`` at the states ``states (C, K, d)`` of the grid points
    ``n0..n0+C-1``, all at once (``torch.func.vmap`` over the points, as the
    reference maps ``jax.vmap``): ``(C, K)``."""
    ns = torch.arange(n0, n0 + states.shape[0], device=states.device)
    return torch.func.vmap(
        lambda psi, n: g_b(psi, trajectories, tlist, n)
    )(states, ns)


def J_b(storage, trajectories, tlist, g_b):
    """State-dependent running cost from stored forward states:
    trapezoid sum ``Σ_k Σ_n ½(g_b(Ψ(t_{n-1})) + g_b(Ψ(t_n))) dt_n``.

    ``storage (N_T+1, K, d)``, ``tlist (N_T+1,)`` a tensor; returns the
    scalar J_b (excluding λ_b).
    """
    w = grid_weights(tlist)
    gvals = running_cost_values(g_b, storage, trajectories, tlist)
    return torch.sum(w[:, None] * gvals)


# --------------------------------------------------------------------------
# Semi-automatic differentiation
# --------------------------------------------------------------------------

def accepts_tau(fn):
    """Whether `fn` has a ``tau`` keyword argument (reference's tau protocol)."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):  # pragma: no cover
        return False
    return "tau" in sig.parameters


def set_default_ad_framework(framework=None, quiet=True):
    """API-familiarity shim for the reference's
    ``QuantumControl.set_default_ad_framework``: in grape_tpu_torch,
    automatic differentiation is always ``torch.autograd`` (built into
    :func:`make_chi`/:func:`make_xi`), so there is nothing to configure.
    Accepts and ignores any framework argument."""
    if not quiet and framework is not None:
        import warnings
        warnings.warn(
            "grape_tpu_torch always uses torch.autograd for semi-automatic "
            "differentiation; set_default_ad_framework is a no-op"
        )


def make_analytic_chi(J_T, chi):
    """Register an analytic ``chi`` for a functional (used by `make_chi`)."""
    _ANALYTIC_CHI[J_T] = chi
    return chi


def make_chi(J_T, trajectories, mode="auto"):
    """Construct ``chi(Psi, trajectories[, tau]) -> χ (K, d)`` for ``J_T``.

    ``mode="analytic"`` requires a registered analytic chi; ``mode="automatic"``
    forces AD; ``mode="auto"`` (default) prefers analytic, falling back to
    ``torch.autograd`` semi-AD:  ``χ = -½ ∇_Ψ J_T`` (no conjugation, see the
    module docstring).
    """
    if mode in ("auto", "analytic") and J_T in _ANALYTIC_CHI:
        return _ANALYTIC_CHI[J_T]
    if mode == "analytic":
        raise ValueError(f"No analytic chi registered for {J_T}")

    J_T_takes_tau = accepts_tau(J_T)

    def chi_ad(Psi, trajectories, tau=None):
        # Differentiate w.r.t. Psi directly; tau (if used by J_T) is
        # recomputed inside so the AD chain rule flows through it.
        P = Psi.detach().clone().requires_grad_(True)
        with torch.enable_grad():
            if J_T_takes_tau:
                val = J_T(P, trajectories, tau=taus(P, trajectories))
            else:
                val = J_T(P, trajectories)
            (g,) = torch.autograd.grad(val, P)
        return -0.5 * g

    return chi_ad


def make_xi(g_b, trajectories):
    """Construct ``xi(Psi, trajectories, tlist, n) -> (K, d)`` from a
    state-dependent running cost ``g_b(Psi, trajectories, tlist, n) -> (K,)``:
    ``ξ_k = -∂g_b/∂⟨Ψ_k| = -½ ∇_{Ψ_k} g_b`` with NO conjugation (torch's
    gradient convention, see the module docstring).  Built on
    ``torch.func.grad``, so it can be mapped over the grid points with
    ``torch.func.vmap``."""

    def xi(Psi, trajectories, tlist, n):
        def scalar(P):
            return torch.sum(g_b(P, trajectories, tlist, n))

        return -0.5 * torch.func.grad(scalar)(Psi)

    return xi


def make_grad_J_a(J_a, tlist):
    """Gradient of a pulse running cost via ``torch.autograd`` (real
    pulsevals); the fluence has its analytic gradient."""
    if J_a is J_a_fluence:
        return grad_J_a_fluence

    def grad_J_a(pulsevals, tlist):
        p = torch.as_tensor(pulsevals).detach().clone().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(J_a(p, tlist), p)
        return g

    return grad_J_a


# --------------------------------------------------------------------------
# Gate functionals
# --------------------------------------------------------------------------

def make_ensemble_gate_functional(n_basis):
    """Robust-gate ensemble functional: coherent within each sample's
    ``n_basis`` gate trajectories, INCOHERENT across samples:

        ``J_T = 1 − Σ_s w_s |(1/n_basis) Σ_{k∈s} τ_k|²``

    A plain :func:`J_T_sm` over all ``S·n_basis`` trajectories sums τ
    coherently ACROSS samples; with per-sample drift perturbations the
    sample overlaps carry different dynamical phases and the coherent sum
    interferes destructively (ensemble members are independent systems;
    only the relative phases WITHIN one gate are physical).

    Trajectory order must be sample-major (all ``n_basis`` basis states of
    sample 0 first, ...).  Per-sample weights may be given through the
    trajectories' ``weight`` attribute (constant within a sample;
    normalized internally).  Returns ``J_T(Psi, trajectories, tau=None)``
    (the batched tau protocol); the co-state comes from ``make_chi``
    semi-AD."""

    def J_T_sm_ensemble(Psi, trajectories, tau=None):
        if tau is None:
            tau = taus(Psi, trajectories)
        K = len(trajectories)
        if K % n_basis != 0:
            raise ValueError(
                f"trajectory count ({K}) is not a multiple of "
                f"n_basis ({n_basis})"
            )
        S = K // n_basis
        w_s = weights_of(trajectories, tau).reshape(S, n_basis)[:, 0]
        w_s = w_s / torch.sum(w_s)
        f = torch.abs(torch.mean(tau.reshape(S, n_basis), dim=1)) ** 2
        return 1.0 - torch.sum(w_s * f)

    return J_T_sm_ensemble


def _basis_of(trajectories, like):
    basis = np.stack([np.asarray(t.initial_state) for t in trajectories])
    return torch.as_tensor(basis, dtype=like.dtype, device=like.device)


def gate_functional(J_T_U, **kwargs):
    """Lift a functional of the logical gate ``U_L`` (matrix ``(K, K)`` with
    ``(U_L)_ij = ⟨φ_i|Ψ_j(T)⟩``) to a standard ``J_T(Psi, trajectories)``.

    The basis states ``φ_i`` are the trajectories' initial states.
    """

    def J_T(Psi, trajectories, tau=None):
        basis = _basis_of(trajectories, Psi)
        U_L = torch.einsum("id,jd->ij", torch.conj(basis), Psi)
        return J_T_U(U_L, **kwargs)

    return J_T


def make_gate_chi(J_T_U, trajectories, **kwargs):
    """``chi`` for a gate functional via AD and the chain rule
    ``χ_k = -½ Σ_i (∇_{U_L} J_T)_ik |φ_i⟩``, with
    ``∇_U J = ∂J/∂Re U + i ∂J/∂Im U``: what ``torch.autograd`` returns for
    a real function of a complex tensor, so, as in :func:`make_chi`, there
    is no conjugation here (the JAX package conjugates ``jax.grad``'s
    result to get the same quantity)."""

    def chi(Psi, trajectories, tau=None):
        basis = _basis_of(trajectories, Psi)
        U_L = torch.einsum("id,jd->ij", torch.conj(basis), Psi.detach())
        U_L = U_L.clone().requires_grad_(True)
        with torch.enable_grad():
            (nabla,) = torch.autograd.grad(J_T_U(U_L, **kwargs), U_L)
        return -0.5 * torch.einsum("ik,id->kd", nabla, basis)

    return chi
