"""L-BFGS with a Moré–Thuente strong-Wolfe line search, on tensors.

Counterpart of ``grape_tpu/optimizers/jax_lbfgs.py``: the direction and
line-search logic of the native C++ optimizer (``native/lbfgsb.cpp`` —
Byrd–Lu–Nocedal–Zhu two-loop recursion, MINPACK-2 ``dcsrch``/``dcstep``
case analysis) on the pulse's device, so the device-resident loop
(``optimizer="device-lbfgs"``, :mod:`.device_loop`) keeps its iterate, its
history and every line-search scalar on the card: typically ONE fg
evaluation per iteration (the unit step satisfies strong Wolfe after the
first few iterations).

The vectors and the memory are float64 tensors on the pulse's device; the
scalars of the line search are 0-d float64 tensors updated branch-free with
``torch.where``, a transliteration of the reference's traced code.  The
host reads one flag per line-search probe (whether to probe again) and,
with box bounds, one per iteration (whether the projection moved the
iterate).

Box bounds are honored by projection of the accepted iterate; curvature
pairs that projection renders indefinite (``y·s ≤ 0``) are skipped.
"""

import torch

__all__ = [
    "lbfgs_direction", "lbfgs_init_state", "morethuente_linesearch",
    "make_lbfgs_iter",
]

# Moré–Thuente tolerances (the native optimizer's: sufficient decrease
# 1e-4, curvature 0.9)
_FTOL = 1e-4
_GTOL = 0.9
_XTOL = 1e-10
_STPMAX = 1e10


def lbfgs_init_state(x, m):
    """Fresh L-BFGS state ``(S (m, n), Y (m, n), rho (m,), count)`` on
    ``x``'s device and dtype, ``count`` a 0-d int64 tensor."""
    n = x.shape[0]
    return (
        torch.zeros((m, n), dtype=x.dtype, device=x.device),
        torch.zeros((m, n), dtype=x.dtype, device=x.device),
        torch.zeros((m,), dtype=x.dtype, device=x.device),
        torch.zeros((), dtype=torch.int64, device=x.device),
    )


def _scalar(v, like):
    """``v`` as a 0-d tensor of ``like``'s dtype and device: a tensor cast
    and copied, a Python number filled in place (no host-to-device copy,
    which would wait for the device)."""
    if torch.is_tensor(v):
        return v.to(dtype=like.dtype, device=like.device).clone()
    return torch.full((), v, dtype=like.dtype, device=like.device)


def lbfgs_direction(g, S, Y, rho, count, m):
    """Two-loop recursion: ``d = -H·g`` from the ``min(count, m)`` most
    recent curvature pairs stored in circular buffers ``S/Y (m, n)``
    (slot ``(count-1) % m`` is newest).  ``rho = 1/(y·s)`` per slot;
    ``gamma = (s·y)/(y·y)`` of the newest pair scales the initial
    Hessian.  Skipped (indefinite) pairs carry ``rho = 0`` and are
    masked out.

    The slots are gathered newest first in one ``index_select`` (an index
    that is a device tensor would cost a host read per use); the second
    loop walks them back, oldest first, where the reference's walks
    ``count - n_pairs + j``: the same valid pairs in the same order, the
    slots never filled adding exact zeros."""
    count = torch.as_tensor(count, dtype=torch.int64, device=g.device)
    zero = _scalar(0.0, g)
    j = torch.arange(m, device=g.device)
    order = torch.remainder(count - 1 - j, m)  # newest first
    S_o, Y_o = S.index_select(0, order), Y.index_select(0, order)
    rho_o = rho.index_select(0, order)
    valid = (j < torch.clamp(count, max=m)) & (rho_o > 0)
    alphas = []
    q = g
    for i in range(m):
        a = torch.where(valid[i], rho_o[i] * torch.dot(S_o[i], q), zero)
        q = q - a * Y_o[i]
        alphas.append(a)
    sy = torch.dot(S_o[0], Y_o[0])
    yy = torch.dot(Y_o[0], Y_o[0])
    gamma = torch.where(
        (count > 0) & (sy > 0) & (yy > 0),
        sy / torch.clamp(yy, min=1e-300), _scalar(1.0, g),
    )
    r = gamma * q
    for i in reversed(range(m)):
        beta = torch.where(valid[i], rho_o[i] * torch.dot(Y_o[i], r), zero)
        r = r + (alphas[i] - beta) * S_o[i]
    return -r


def _dcstep(stx, fx, dx, sty, fy, dy, stp, fp, dp, brackt, stmin, stmax):
    """MINPACK-2 ``dcstep``: safeguarded cubic/quadratic trial-step
    update for one line-search interval refinement (the four-case
    analysis; same algorithm as ``native/lbfgsb.cpp``).  All 0-d tensors,
    branch-free via ``where`` cascades (unselected branches may produce
    NaN from guarded divisions — ``where`` discards them)."""
    where = torch.where
    one = torch.ones_like(stp)

    def safe_div(p, q):
        return p / where(q == 0.0, one, q)

    sgnd = dp * torch.sign(dx)

    # common cubic ingredients between (stx, fx, dx) and (stp, fp, dp)
    dstp = stp - stx
    theta = safe_div(3.0 * (fx - fp), dstp) + dx + dp
    s = torch.maximum(
        torch.abs(theta), torch.maximum(torch.abs(dx), torch.abs(dp))
    )
    s_safe = where(s == 0.0, one, s)
    disc = (theta / s_safe) ** 2 - (dx / s_safe) * (dp / s_safe)
    gamma0 = s * torch.sqrt(torch.clamp(disc, min=0.0))

    # case 1: fp > fx — minimum bracketed between stx and stp
    g1 = where(stp < stx, -gamma0, gamma0)
    p1 = (g1 - dx) + theta
    q1 = ((g1 - dx) + g1) + dp
    stpc1 = stx + safe_div(p1, q1) * dstp
    stpq1 = stx + 0.5 * safe_div(dx, safe_div(fx - fp, dstp) + dx) * dstp
    stpf1 = where(
        torch.abs(stpc1 - stx) < torch.abs(stpq1 - stx),
        stpc1, stpc1 + 0.5 * (stpq1 - stpc1),
    )

    # case 2: sgnd < 0 — derivative sign change brackets the minimum
    g2 = where(stp > stx, -gamma0, gamma0)
    p2 = (g2 - dp) + theta
    q2 = ((g2 - dp) + g2) + dx
    stpc2 = stp + safe_div(p2, q2) * (stx - stp)
    stpq2 = stp + safe_div(dp, dp - dx) * (stx - stp)
    stpf2 = where(
        torch.abs(stpc2 - stp) > torch.abs(stpq2 - stp), stpc2, stpq2
    )

    # case 3: |dp| < |dx|, same sign, f decreased — cubic may not have a
    # minimizer in the step direction
    g3 = where(stp > stx, -gamma0, gamma0)
    p3 = (g3 - dp) + theta
    q3 = (g3 + (dx - dp)) + g3
    r3 = safe_div(p3, q3)
    stpc3 = where(
        (r3 < 0.0) & (gamma0 != 0.0),
        stp + r3 * (stx - stp),
        where(stp > stx, stmax, stmin),
    )
    stpq3 = stp + safe_div(dp, dp - dx) * (stx - stp)
    stpf3_br = where(
        torch.abs(stpc3 - stp) < torch.abs(stpq3 - stp), stpc3, stpq3
    )
    stpf3_br = where(
        stp > stx,
        torch.minimum(stp + 0.66 * (sty - stp), stpf3_br),
        torch.maximum(stp + 0.66 * (sty - stp), stpf3_br),
    )
    stpf3_nb = where(
        torch.abs(stpc3 - stp) > torch.abs(stpq3 - stp), stpc3, stpq3
    )
    stpf3 = where(
        brackt, stpf3_br,
        torch.minimum(torch.maximum(stpf3_nb, stmin), stmax),
    )

    # case 4: |dp| >= |dx| — use the far endpoint (sty) cubic if bracketed
    dstp4 = sty - stp
    theta4 = safe_div(3.0 * (fp - fy), dstp4) + dy + dp
    s4 = torch.maximum(
        torch.abs(theta4), torch.maximum(torch.abs(dy), torch.abs(dp))
    )
    s4_safe = where(s4 == 0.0, one, s4)
    disc4 = (theta4 / s4_safe) ** 2 - (dy / s4_safe) * (dp / s4_safe)
    g4 = s4 * torch.sqrt(torch.clamp(disc4, min=0.0))
    g4 = where(stp > sty, -g4, g4)
    p4 = (g4 - dp) + theta4
    q4 = ((g4 - dp) + g4) + dy
    stpc4 = stp + safe_div(p4, q4) * dstp4
    stpf4 = where(brackt, stpc4, where(stp > stx, stmax, stmin))

    case1 = fp > fx
    case2 = (~case1) & (sgnd < 0.0)
    case3 = (~case1) & (~case2) & (torch.abs(dp) < torch.abs(dx))
    stpf = where(
        case1, stpf1, where(case2, stpf2, where(case3, stpf3, stpf4)),
    )
    new_brackt = brackt | case1 | case2

    # interval update
    upd_y_to_p = case1                       # fp > fx: sty <- stp
    upd_y_to_x = (~case1) & (sgnd < 0.0)     # sign change: sty <- stx
    sty_n = where(upd_y_to_p, stp, where(upd_y_to_x, stx, sty))
    fy_n = where(upd_y_to_p, fp, where(upd_y_to_x, fx, fy))
    dy_n = where(upd_y_to_p, dp, where(upd_y_to_x, dx, dy))
    stx_n = where(case1, stx, stp)
    fx_n = where(case1, fx, fp)
    dx_n = where(case1, dx, dp)
    return stx_n, fx_n, dx_n, sty_n, fy_n, dy_n, stpf, new_brackt


def morethuente_linesearch(fg, x, d, f0, dg0, stp0, aux0, g0,
                           maxls=20, ftol=_FTOL, gtol=_GTOL, xtol=_XTOL,
                           stpmax=_STPMAX):
    """Strong-Wolfe line search along ``d`` from ``x`` (the MINPACK-2
    ``dcsrch`` state machine; one fg evaluation per trial).
    ``fg(x) -> (f, g, aux)``.  The host reads one flag per trial: whether
    the search goes on.

    Returns ``(stp, f, g, aux, nfev, ok)`` at the accepted trial (the
    last evaluated point when the search exhausts ``maxls`` — the
    reverse-communication optimizer's abnormal-exit behavior); ``nfev``
    is a Python int, the rest tensors."""
    where = torch.where

    def f64(v):
        return _scalar(v, x)

    f0 = f64(f0)
    dg0 = f64(dg0)
    stp0 = f64(stp0)
    gtest = ftol * dg0
    stp_next = stp0
    stp, f, dg, g, aux = f64(0.0), f0, dg0, g0, aux0
    stx, fx, dx = f64(0.0), f0, dg0
    sty, fy, dy = f64(0.0), f0, dg0
    brackt = torch.zeros((), dtype=torch.bool, device=x.device)
    stage1 = ~brackt
    stmin, stmax = f64(0.0), stp0 + 4.0 * stp0
    width, width1 = f64(stpmax), f64(2.0 * stpmax)
    ok = brackt.clone()
    nfev = 0
    while nfev < maxls:
        stp = stp_next
        f, g, aux = fg(x + stp * d)
        f = f.to(x.dtype)
        g = g.to(x.dtype)
        dg = torch.dot(g, d)
        nfev += 1

        ftest = f0 + stp * gtest
        stage1 = stage1 & ~((f <= ftest) & (dg >= 0.0))

        # strong Wolfe: sufficient decrease + curvature
        wolfe = (f <= ftest) & (torch.abs(dg) <= gtol * (-dg0))
        # degenerate exits (interval collapse / step at bounds)
        stuck = brackt & (
            (stp <= stmin) | (stp >= stmax)
            | (stmax - stmin <= xtol * stmax)
        )
        at_max = (stp >= stpmax) & (f <= ftest) & (dg <= gtest)
        done = wolfe | stuck | at_max
        ok = ok | wolfe

        # modified function for stage 1 (psi trick): auxiliary values
        use_mod = stage1 & (f <= fx) & (f > ftest)
        fm = where(use_mod, f - stp * gtest, f)
        fxm = where(use_mod, fx - stx * gtest, fx)
        fym = where(use_mod, fy - sty * gtest, fy)
        dgm = where(use_mod, dg - gtest, dg)
        dxm = where(use_mod, dx - gtest, dx)
        dym = where(use_mod, dy - gtest, dy)

        stx, fx, dx, sty, fy, dy, stpf, brackt_n = _dcstep(
            stx, fxm, dxm, sty, fym, dym, stp, fm, dgm, brackt, stmin,
            stmax,
        )
        fx = where(use_mod, fx + stx * gtest, fx)
        fy = where(use_mod, fy + sty * gtest, fy)
        dx = where(use_mod, dx + gtest, dx)
        dy = where(use_mod, dy + gtest, dy)

        # bisection safeguard + interval bookkeeping
        too_slow = brackt_n & (torch.abs(sty - stx) >= 0.66 * width1)
        stpf = where(too_slow, stx + 0.5 * (sty - stx), stpf)
        width1 = where(brackt_n, width, width1)
        width = where(brackt_n, torch.abs(sty - stx), width)
        stmin = where(
            brackt_n, torch.minimum(stx, sty), stpf + 1.1 * (stpf - stx)
        )
        stmax = where(
            brackt_n, torch.maximum(stx, sty), stpf + 4.0 * (stpf - stx)
        )
        stpf = torch.clamp(stpf, 0.0, stpmax)
        # interval collapsed: re-evaluate at the best endpoint next
        stp_next = where(
            brackt_n & (
                (stpf <= stmin) | (stpf >= stmax)
                | (stmax - stmin <= xtol * stmax)
            ),
            stx, stpf,
        )
        brackt = brackt_n
        if bool(done):  # the one read per trial
            break
    return stp, f, g, aux, nfev, ok


def make_lbfgs_iter(fg, n, m=10, lower=None, upper=None, maxls=20):
    """One L-BFGS iteration for the device-resident chunk.

    ``fg(x) -> (f, g, aux)``.  State: ``(S (m,n), Y (m,n), rho (m,),
    count)``.  Returns ``(init_state, step)`` with ``step(x, state, f, g,
    aux0) -> (x2, state2, f2, g2, aux2, alpha, nfev)``; the accepted iterate
    is projected onto the box ``[lower, upper]`` when given (re-evaluated
    there when the projection moved it), and curvature pairs the projection
    renders indefinite are skipped (``rho = 0``)."""
    project = lower is not None and upper is not None

    def init_state(x):
        return lbfgs_init_state(x, m)

    def step(x, state, f, g, aux0):
        S, Y, rho, count = state
        f = f.to(x.dtype)
        g = g.to(x.dtype)
        d = lbfgs_direction(g, S, Y, rho, count, m)
        dg0 = torch.dot(g, d)
        # non-descent safeguard (projection/skipped pairs can spoil the
        # metric): fall back to steepest descent
        descent = dg0 < 0.0
        d = torch.where(descent, d, -g)
        dg0 = torch.where(descent, dg0, -torch.dot(g, g))
        dnorm = torch.sqrt(torch.sum(d * d))
        # first iteration: scaled step like L-BFGS-B's initial 1/||d||
        stp0 = torch.where(
            count == 0, 1.0 / torch.clamp(dnorm, min=1e-12),
            torch.ones_like(dnorm),
        )
        stp, f2, g2, aux2, nfev, _ok = morethuente_linesearch(
            fg, x, d, f, dg0, stp0, aux0, g, maxls=maxls,
        )
        x_trial = x + stp * d
        if project:
            x2 = torch.minimum(torch.maximum(x_trial, lower), upper)
            # projection changed the point: re-evaluate there so the
            # reported (f, g) and the next curvature pair are consistent
            if bool(torch.any(x2 != x_trial)):
                f2, g2, aux2 = fg(x2)
                f2 = f2.to(x.dtype)
                g2 = g2.to(x.dtype)
                nfev += 1
        else:
            x2 = x_trial
        s = x2 - x
        y = g2 - g
        ys = torch.dot(y, s)
        good = ys > 1e-10 * torch.sqrt(
            torch.clamp(torch.dot(s, s) * torch.dot(y, y), min=1e-300)
        )
        slot = torch.remainder(count, m)
        S2 = torch.where(good, S.index_put((slot,), s), S)
        Y2 = torch.where(good, Y.index_put((slot,), y), Y)
        rho2 = torch.where(
            good,
            rho.index_put(
                (slot,), 1.0 / torch.where(ys == 0, torch.ones_like(ys), ys)
            ),
            rho,
        )
        count2 = count + good.to(count.dtype)
        return x2, (S2, Y2, rho2, count2), f2, g2, aux2, stp, nfev

    return init_state, step
