"""``evals_per_iter``: the program's own count of evaluations
(``GrapeResult.fg_calls + f_calls`` of every solve in the window, the
evaluation at each guess included) over the iterations of the window."""


def read(ctx):
    n = ctx.window.n_iters
    if not n or not ctx.window.solves:
        return None
    evals = sum(s["fg_calls"] + s["f_calls"] for s in ctx.window.solves)
    return evals / n
