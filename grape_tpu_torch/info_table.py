"""Per-iteration info table.

Python port of ``make_grape_print_iters`` (``src/optimize.jl:231-537``):
a callback that prints a fixed-width progress table and/or returns a tuple of
requested values for ``result.records``.  Supports the reference's full set of
column labels, delta-columns rendered as ``n/a`` at iteration 0, label
validation, and the g_b label-mismatch warnings.
"""

import warnings

import numpy as np

__all__ = ["make_grape_print_iters", "HEADERS", "DELTA_HEADERS"]

HEADERS = [
    "iter.", "J_T", "J_a", "J_b", "λ_a⋅J_a", "λ_b⋅J_b", "J",
    "ǁ∇J_Tǁ", "ǁ∇(J_T+λ_b·J_b)ǁ", "ǁ∇J_aǁ", "λ_aǁ∇J_aǁ",
    "λ_a⋅ΔJ_a", "λ_b⋅ΔJ_b",
    "ǁ∇Jǁ", "ǁΔϵǁ", "ǁϵǁ", "max|Δϵ|", "max|ϵ|", "ǁΔϵǁ/ǁϵǁ", "∫Δϵ²dt",
    "ǁsǁ", "∠°", "α",
    "ΔJ_T", "ΔJ_a", "ΔJ_b", "ΔJ", "FG(F)", "secs",
]

DELTA_HEADERS = {
    "ΔJ_T", "λ_a⋅ΔJ_a", "ΔJ_a", "ΔJ_b", "λ_b⋅ΔJ_b", "ΔJ",
    "ǁΔϵǁ", "ǁΔϵǁ/ǁϵǁ", "max|Δϵ|", "∫Δϵ²dt", "α", "ǁsǁ",
}

_DEFAULT_PRINT = ["iter.", "J_T", "ǁ∇Jǁ", "ǁΔϵǁ", "ΔJ", "FG(F)", "secs"]


def make_grape_print_iters(
    print_iter_info=None, store_iter_info=None, print_iters=True, g_b=None
):
    store_iter_info = list(store_iter_info or [])
    bad = [f for f in store_iter_info if f not in HEADERS]
    if bad:
        warnings.warn(f"Invalid {bad} not in allowed fields = {HEADERS}")
        raise ValueError(f"store_iter_info contains invalid elements {bad}")
    if print_iter_info is None:
        print_iter_info = list(_DEFAULT_PRINT) if print_iters else []
    bad = [f for f in print_iter_info if f not in HEADERS]
    if bad:
        warnings.warn(f"Invalid {bad} not in allowed fields = {HEADERS}")
        raise ValueError(f"print_iter_info contains invalid elements {bad}")
    needed = set(store_iter_info) | set(print_iter_info)

    def print_table(wrk, iteration):
        from .workspace import (
            gradient, norm_search, search_direction, step_width, vec_angle,
        )

        lambda_a = wrk.kwargs.get("lambda_a", 1.0)
        lambda_b = wrk.kwargs.get("lambda_b", 1.0)
        res = wrk.result
        info = {}
        if iteration == 0:
            has_g_b = not (
                wrk.kwargs.get("g_b", None) is None or lambda_b == 0
            )
            if has_g_b and "ǁ∇J_Tǁ" in needed:
                warnings.warn(
                    'The label "ǁ∇J_Tǁ" was requested, but the optimization '
                    "includes a state-dependent running cost `g_b`. The "
                    "gradient stored in `wrk.grad_J_Tb` is the combined "
                    "gradient of J_T + λ_b·J_b. Consider using the label "
                    '"ǁ∇(J_T+λ_b·J_b)ǁ" instead.'
                )
            if not has_g_b and "ǁ∇(J_T+λ_b·J_b)ǁ" in needed:
                warnings.warn(
                    'The label "ǁ∇(J_T+λ_b·J_b)ǁ" was requested, but the '
                    "optimization does not include a state-dependent "
                    "running cost `g_b`."
                )
        info["iter."] = iteration
        info["J_T"] = res.J_T
        info["ΔJ_T"] = res.J_T - res.J_T_prev
        info["J_a"] = res.J_a
        info["λ_a⋅J_a"] = wrk.J_parts[1]
        dJ_a = res.J_a - res.J_a_prev
        info["ΔJ_a"] = dJ_a
        info["λ_a⋅ΔJ_a"] = lambda_a * dJ_a
        info["J_b"] = res.J_b
        info["λ_b⋅J_b"] = wrk.J_parts[2]
        dJ_b = res.J_b - res.J_b_prev
        info["ΔJ_b"] = dJ_b
        info["λ_b⋅ΔJ_b"] = lambda_b * dJ_b
        info["J"] = res.J_T + lambda_a * res.J_a + lambda_b * res.J_b
        if "ǁ∇J_Tǁ" in needed or "ǁ∇(J_T+λ_b·J_b)ǁ" in needed:
            nrm = float(np.linalg.norm(wrk.grad_J_Tb))
            info["ǁ∇J_Tǁ"] = nrm
            info["ǁ∇(J_T+λ_b·J_b)ǁ"] = nrm
        if "ǁ∇J_aǁ" in needed or "λ_aǁ∇J_aǁ" in needed:
            nrm = float(np.linalg.norm(wrk.grad_J_a))
            info["ǁ∇J_aǁ"] = nrm
            info["λ_aǁ∇J_aǁ"] = lambda_a * nrm
        if "ǁ∇Jǁ" in needed:
            info["ǁ∇Jǁ"] = float(np.linalg.norm(gradient(wrk, which="initial")))
        if "ΔJ" in needed:
            J = res.J_T + lambda_a * res.J_a + lambda_b * res.J_b
            J_prev = (
                res.J_T_prev + lambda_a * res.J_a_prev
                + lambda_b * res.J_b_prev
            )
            info["ΔJ"] = J - J_prev
        pulse_fields = {
            "ǁΔϵǁ/ǁϵǁ", "ǁΔϵǁ", "ǁϵǁ", "max|ϵ|", "max|Δϵ|", "∫Δϵ²dt",
        }
        if needed & pulse_fields:
            N = len(res.tlist) - 1
            dt = np.diff(res.tlist)
            eps = np.asarray(wrk.pulsevals)
            deps = eps - np.asarray(wrk.pulsevals_guess)
            dt_full = np.tile(dt, len(eps) // N)
            info["ǁϵǁ"] = float(np.linalg.norm(eps))
            info["ǁΔϵǁ"] = float(np.linalg.norm(deps))
            info["ǁΔϵǁ/ǁϵǁ"] = (
                info["ǁΔϵǁ"] / info["ǁϵǁ"] if info["ǁϵǁ"] > 0 else 0.0
            )
            info["max|ϵ|"] = float(np.max(np.abs(eps)))
            info["max|Δϵ|"] = float(np.max(np.abs(deps)))
            info["∫Δϵ²dt"] = float(np.sum(deps**2 * dt_full))
        if "ǁsǁ" in needed:
            info["ǁsǁ"] = norm_search(wrk)
        if "α" in needed:
            info["α"] = step_width(wrk)
        if "∠°" in needed:
            s_G = -gradient(wrk, which="initial")
            s = search_direction(wrk)
            info["∠°"] = vec_angle(s_G, s, unit="degree")
        info["FG(F)"] = (int(wrk.fg_count[0]), int(wrk.fg_count[1]))
        info["secs"] = res.secs

        iter_stop = str(wrk.kwargs.get("iter_stop", 5000))
        width = {
            "iter.": max(len(iter_stop), 6),
            "FG(F)": 8,
            "secs": 8,
            "∠°": 7,
            "ǁ∇(J_T+λ_b·J_b)ǁ": 17,
        }

        if print_iter_info:
            lines = []
            if iteration == 0:
                lines.append(
                    "".join(
                        h.rjust(width.get(h, 11)) for h in print_iter_info
                    )
                )
            cells = []
            for h in print_iter_info:
                if h == "iter.":
                    s = str(info[h])
                elif h == "FG(F)":
                    s = "%d(%d)" % info[h]
                elif h == "secs":
                    s = "%.1f" % info[h]
                elif h in DELTA_HEADERS:
                    s = "%.2e" % info[h] if iteration > 0 else "n/a"
                elif h == "∠°":
                    s = "%.1f" % info["∠°"] if iteration > 0 else "n/a"
                else:
                    s = "%.2e" % info[h]
                cells.append(s.rjust(width.get(h, 11)))
            lines.append("".join(cells))
            print("\n".join(lines), flush=True)

        return tuple(info[f] for f in store_iter_info)

    return print_table
