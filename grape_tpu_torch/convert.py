"""State carried across from the reference: build the port's
:class:`~grape_tpu_torch.fg.CompiledProblem` from plain numpy arrays.

A caller that has compiled a problem elsewhere (the parity tests read the
fields off the JAX package's ``CompiledProblem``) hands the arrays over as a
dict of numpy arrays and Python scalars, so both sides compute on
bit-identical inputs.  This module imports nothing of the JAX package.
"""

import numpy as np

from . import functionals
from .config import complex_dtype, numpy_dtype, real_dtype, resolve_device
from .fg import CompiledProblem, _make_norm_cache
from .functionals import accepts_tau, make_chi, make_grad_J_a
from .trajectory import Trajectory

__all__ = ["compiled_problem_from_numpy"]


def _functional(fn):
    """A functional given by name (``"J_T_sm"``) or as a callable."""
    if fn is None or callable(fn):
        return fn
    try:
        return getattr(functionals, str(fn))
    except AttributeError:
        raise ValueError(
            f"unknown functional {fn!r}: not in grape_tpu_torch.functionals"
        ) from None


def compiled_problem_from_numpy(arrays, *, J_T, chi=None, J_a=None,
                                grad_J_a=None, lambda_a=1.0,
                                chi_min_norm=1e-100, dtype=None,
                                device=None):
    """The port's ``CompiledProblem`` from the reference's arrays.

    ``arrays`` holds ``psi0 (K, d)``, ``H0 (1, d, d)``, ``ops (1, T, d, d)``,
    ``M (N_T, T, L)``, ``Mfix (N_T, T)``, ``tlist (N_T+1,)``,
    ``guess_pulsevals (L, N_T)``, ``ctl_idx`` (one entry per term, ``None``
    for a locked term), ``shared_generator`` (must be true), and optionally
    ``norm_cache`` (``{"h0", "ops"}``), ``target_states (K, d)`` and
    ``weights (K,)``.  ``J_T`` / ``chi`` / ``J_a`` are callables of this
    package or their names (``"J_T_sm"``).  ``dtype=None`` keeps the dtype
    of ``psi0``.
    """
    device = resolve_device(device)
    if not bool(arrays.get("shared_generator", False)):
        raise NotImplementedError(
            "per-trajectory generators are not ported to grape_tpu_torch "
            "yet: shared_generator must be true"
        )
    psi0 = np.asarray(arrays["psi0"])
    cdtype = complex_dtype(numpy_dtype(dtype if dtype is not None
                                       else psi0.dtype))
    rdtype = real_dtype(cdtype)
    psi0 = psi0.astype(cdtype)
    H0 = np.asarray(arrays["H0"]).astype(cdtype)
    ops = np.asarray(arrays["ops"]).astype(cdtype)
    if H0.ndim != 3 or H0.shape[0] != 1 or ops.ndim != 4 or ops.shape[0] != 1:
        raise ValueError(
            "H0 must be (1, d, d) and ops (1, T, d, d): one shared generator"
        )
    M = np.asarray(arrays["M"], dtype=rdtype)
    Mfix = np.asarray(arrays["Mfix"], dtype=rdtype)
    if M.ndim != 3:
        raise NotImplementedError(
            "per-trajectory coefficient tables are not ported yet"
        )
    tlist = np.asarray(arrays["tlist"], dtype=rdtype)
    guess = np.asarray(arrays["guess_pulsevals"], dtype=np.float64)
    K, d = psi0.shape
    N_T, _, L = M.shape

    targets = arrays.get("target_states")
    weights = arrays.get("weights")
    trajectories = []
    for k in range(K):
        kw = {}
        if targets is not None:
            kw["target_state"] = np.asarray(targets[k])
        if weights is not None:
            kw["weight"] = float(weights[k])
        trajectories.append(Trajectory(psi0[k], None, **kw))
    has_targets = targets is not None

    J_T = _functional(J_T)
    chi = _functional(chi)
    J_a = _functional(J_a)
    grad_J_a = _functional(grad_J_a)
    if chi is None:
        chi = make_chi(J_T, trajectories)
    if J_a is not None and grad_J_a is None:
        grad_J_a = make_grad_J_a(J_a, tlist)

    norm_cache = arrays.get("norm_cache")
    if norm_cache is None:
        norm_cache = _make_norm_cache(H0, ops)
    else:
        norm_cache = {
            "h0": float(norm_cache["h0"]),
            "ops": np.asarray(norm_cache["ops"], dtype=np.float64),
        }
    return CompiledProblem(
        psi0=psi0, H0=H0, ops=ops, M=M, Mfix=Mfix, tlist=tlist,
        trajectories=trajectories,
        controls=tuple(guess[l] for l in range(L)),
        guess_pulsevals=guess,
        n_controls=L, n_timesteps=N_T, dim=d, n_traj=K,
        J_T=J_T, chi=chi, J_a=J_a, grad_J_a=grad_J_a,
        lambda_a=float(lambda_a),
        chi_min_norm=float(chi_min_norm),
        J_T_takes_tau=accepts_tau(J_T) and has_targets,
        chi_takes_tau=accepts_tau(chi) and has_targets,
        has_targets=has_targets,
        ctl_idx=tuple(arrays.get("ctl_idx", ())),
        shared_generator=True,
        norm_cache=norm_cache,
        device=device,
    )
