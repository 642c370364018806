"""Result persistence and disk checkpointing, the counterpart of
``grape_tpu.io``: results are pickled as plain Python values and numpy
arrays (never a torch tensor, so a file written on the card loads on a
machine without one) and can be reloaded and used as ``continue_from``
warm starts.

``optimize_or_load`` is config-aware: a digest of the problem
configuration is stored with the result, and a checkpoint produced by a
DIFFERENT configuration triggers a warning and a re-run instead of
silently returning the stale result.  A crash dump (``optimize``'s
``atexit_filename``) is resumed, never returned as a finished result.
"""

import datetime
import hashlib
import os
import pickle

import numpy as np
import torch

__all__ = [
    "save_result", "load_result", "optimize_or_load", "load_optimization",
    "config_digest",
]


def _describe(v):
    """Stable, address-free description of one config value for the
    digest.  Callables hash by qualified name PLUS captured content —
    bytecode, defaults, and closure-cell values — so two closures with
    the same name but different captured parameters (the common case:
    ``mk_guess(E0)`` for different ``E0``) get different digests.
    Arrays hash by content."""
    if callable(v):
        mod = getattr(v, "__module__", "?")
        qn = getattr(v, "__qualname__", type(v).__name__)
        parts = [f"fn:{mod}.{qn}"]
        code = getattr(v, "__code__", None)
        if code is not None:
            parts.append(
                "co:" + hashlib.sha1(code.co_code).hexdigest()[:12]
            )
        for attr in ("__defaults__", "__kwdefaults__"):
            dv = getattr(v, attr, None)
            if dv:
                vals = dv.values() if isinstance(dv, dict) else dv
                parts.append(
                    attr[2:4] + ":" + ",".join(_describe(u) for u in vals)
                )
        cells = getattr(v, "__closure__", None)
        if cells:
            cell_descs = []
            for cell in cells:
                try:
                    cv = cell.cell_contents
                except ValueError:  # empty cell
                    cell_descs.append("<empty>")
                    continue
                if callable(cv) and getattr(cv, "__closure__", None):
                    # avoid unbounded recursion through mutually-
                    # referencing closures: one level of nesting only
                    cell_descs.append(
                        f"fn:{getattr(cv, '__qualname__', '?')}"
                    )
                else:
                    cell_descs.append(_describe(cv))
            parts.append("cl:[" + ",".join(cell_descs) + "]")
        return ";".join(parts)
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    if isinstance(v, np.ndarray):
        return (
            f"ndarray{v.shape}:"
            + hashlib.sha1(np.ascontiguousarray(v).tobytes()).hexdigest()[:16]
        )
    if isinstance(v, dict):
        inner = ",".join(
            f"{k}={_describe(v[k])}" for k in sorted(v, key=str)
        )
        return "{" + inner + "}"
    if isinstance(v, (list, tuple)):
        return "[" + ",".join(_describe(u) for u in v) + "]"
    return repr(v)


# presentation/observation kwargs that do not change the produced
# result: excluded from the digest so toggling them does not invalidate
# a checkpoint
_DIGEST_EXCLUDE = frozenset({
    "print_iters", "print_iter_info", "store_iter_info", "verbose",
    "rethrow_exceptions", "callback", "atexit_filename",
    "atexit_config_digest", "profile_dir",
})


def _describe_trajectory(t):
    """Content description of one trajectory: states, weight, and the
    generator's operator content + amplitude identities — the part of
    the configuration most likely to change between runs (perturbed
    Hamiltonians, new targets)."""
    parts = [f"psi0={_describe(np.asarray(t.initial_state))}"]
    tgt = getattr(t, "target_state", None)
    parts.append(
        "tgt=" + (_describe(np.asarray(tgt)) if tgt is not None else "None")
    )
    parts.append(f"w={getattr(t, 'weight', 1.0)!r}")
    gen = getattr(t, "generator", None)
    if gen is not None and hasattr(gen, "terms"):
        parts.append("H0=" + _describe(np.asarray(gen.drift)))
        for op, amp in gen.terms:
            parts.append(
                "term=" + _describe(np.asarray(op)) + ":" + _describe(amp)
            )
    elif gen is not None:
        parts.append("gen=" + _describe(gen))
    return ";".join(parts)


def config_digest(trajectories, tlist, kwargs):
    """Digest of the optimization configuration — trajectory CONTENT
    (states, weights, generator operators/amplitudes), the full time
    grid, and all result-affecting kwargs — used by
    :func:`optimize_or_load` to detect a stale checkpoint."""
    trajectories = list(trajectories)  # may be a generator: materialize
    tlist = np.asarray(tlist, dtype=float)
    parts = [
        f"n_traj={len(trajectories)}",
        "tlist=" + _describe(tlist),
    ]
    for t in trajectories:
        parts.append(_describe_trajectory(t))
    for key in sorted(kwargs, key=str):
        if key in _DIGEST_EXCLUDE:
            continue
        parts.append(f"{key}={_describe(kwargs[key])}")
    return hashlib.sha1("|".join(parts).encode()).hexdigest()


def _host(v):
    """``v`` with every torch tensor inside it (in dicts, lists, tuples)
    as a numpy array on the host."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if isinstance(v, dict):
        return {k: _host(u) for k, u in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_host(u) for u in v)
    return v


def save_result(result, filename, config_digest=None, interrupted=False):
    """Serialize a :class:`GrapeResult` to disk (optionally tagged with
    the producing configuration's digest).  ``interrupted=True`` marks
    a crash dump (atexit save of an in-progress result): ``
    optimize_or_load`` then resumes/re-runs instead of returning it as a
    finished result."""
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    data = _host(result.to_dict())
    if config_digest is not None:
        data["config_digest"] = config_digest
    if interrupted:
        data["interrupted"] = True
    with open(filename, "wb") as fh:
        pickle.dump(data, fh)


class _LoadedResult:
    """A result reloaded from disk (duck-types GrapeResult for
    ``continue_from`` and attribute access)."""

    def __init__(self, data):
        for key, val in data.items():
            setattr(self, key, val)

    def __repr__(self):
        return f"GrapeResult<{self.message}> (loaded)"


def load_result(filename):
    """The result saved in ``filename``: a Krotov result (``method`` =
    ``"krotov"`` in its data) as a
    :class:`~grape_tpu_torch.krotov.KrotovResult`, anything else as a
    duck-typed :class:`GrapeResult`."""
    with open(filename, "rb") as fh:
        data = pickle.load(fh)
    if data.get("method") == "krotov":
        from .krotov import KrotovResult

        res = KrotovResult.__new__(KrotovResult)
        # the times are not saved: a continued run starts its clock anew
        res.start_local_time = res.end_local_time = datetime.datetime.now()
        res.__dict__.update(data)
        res.__dict__.pop("method")
        return res
    return _LoadedResult(data)


def load_optimization(filename):
    """Reference ``load_optimization`` analog."""
    return load_result(filename)


def optimize_or_load(filename, trajectories, tlist, force=False, **kwargs):
    """Run :func:`grape_tpu_torch.optimize` and persist the result to `filename`;
    if `filename` already holds a result FROM THE SAME CONFIGURATION,
    load and return it instead (``@optimize_or_load`` analog).  A
    checkpoint whose stored config digest differs from the current
    arguments is stale: a warning is emitted and the optimization
    re-runs, overwriting the file (``force=True`` always re-runs).
    Files written before digests existed load unconditionally.  The
    optimization runs with ``atexit_filename`` set so that a crash still
    dumps the in-progress result."""
    from .optimize import optimize

    trajectories = list(trajectories)  # may be a generator: digesting
    # and optimizing both iterate it, so materialize exactly once
    digest = config_digest(trajectories, tlist, kwargs)
    continue_from = None
    if os.path.exists(filename) and not force:
        loaded = load_result(filename)
        stored = getattr(loaded, "config_digest", None)
        interrupted = bool(getattr(loaded, "interrupted", False))
        if not interrupted and (stored is None or stored == digest):
            return loaded
        import warnings

        if interrupted:
            if stored is None or stored == digest:
                warnings.warn(
                    f"checkpoint {filename} is a crash dump of an "
                    "interrupted optimization; resuming from it "
                    "instead of returning the partial result"
                )
                continue_from = loaded
            else:
                warnings.warn(
                    f"checkpoint {filename} is a crash dump from a "
                    "DIFFERENT configuration; re-running the "
                    "optimization and overwriting it"
                )
        else:
            warnings.warn(
                f"checkpoint {filename} was produced by a different "
                "configuration (config digest mismatch); re-running the "
                "optimization and overwriting it"
            )
    run_kwargs = dict(kwargs)
    if continue_from is not None and "continue_from" not in run_kwargs:
        if getattr(continue_from, "optimized_controls", None) is not None:
            run_kwargs["continue_from"] = continue_from
    result = optimize(
        trajectories, tlist, atexit_filename=filename,
        atexit_config_digest=digest, **run_kwargs
    )
    save_result(result, filename, config_digest=digest)
    return result
