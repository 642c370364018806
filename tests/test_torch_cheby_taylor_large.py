"""The benchmark's large two-transmon gate (kind ``two_transmon_gate_large``,
cell ``cz1024.cheby``) at a size the CPU runs in seconds, through the
cell's own options: Chebyshev propagation both ways and the time-vectorized
Taylor gradient, compiled as ``optimize_problem`` compiles it
(``workspace._compile_kwargs`` into ``compile_problem``) and evaluated by
``build_fg`` at the envelope bucket that ``GrapeWrk`` takes.

- complex128 against the benchmark's plain reference (autograd through
  ``torch.linalg.matrix_exp``) on seeded random pulses;
- complex64 against complex128, within the limits of the cell's check;
- the counters ``hopper_cheby.terms`` and ``fg.taylor_orders`` against a
  hand count at dim 256 (the Chebyshev-scan wrapper's gate), on the CPU
  in the wrapper's plain version."""

import json
import math
import os

import numpy as np
import pytest
import torch

from benchmark.harness import spec
from benchmark.programs import two_transmon_gate_large as kind
from benchmark.reference.two_transmon_gate_large import Reference
from grape_tpu_torch import fg as F
from grape_tpu_torch.ops import hopper_cheby
from grape_tpu_torch.ops.cheby import cheby_coeffs
from grape_tpu_torch.workspace import GrapeWrk, _compile_kwargs

torch.set_num_threads(1)

CELL = "cz1024.cheby"
CONFIG = spec.load_json(os.path.join(spec.ROOT, "benchmark", "configs",
                                     "cz_transmon_d1024.json"))
TRAFFIC = spec.load_json(os.path.join(spec.BENCH_DIR, "traffic",
                                      "cheby_taylor_full.json"))
LIMITS = spec.load_json(os.path.join(spec.BENCH_DIR, "workloads",
                                     CELL + ".json"))["limits"]


def small(levels=4, n_steps=20):
    return dict(CONFIG, levels=levels, n_steps=n_steps, T=1.0)


def pulses(config, seed):
    """Seeded random pulses at the traffic's peaks: x quadratures about
    2.5, y quadratures a fifth of it."""
    r = np.random.default_rng(seed)
    peak = TRAFFIC["guess"]["amplitude"]
    scale = np.array([1.0, 0.2, 1.0, 0.2])[:, None] * peak
    return scale * r.uniform(-1.0, 1.0, size=(4, config["n_steps"]))


def compiled(config, guess, dtype):
    program = kind.Program(config, kind.draw(config, 0))
    problem = program.problem(guess)
    kwargs = dict(problem.kwargs, **TRAFFIC["options"], dtype=dtype,
                  device="cpu")
    cp = F.compile_problem(problem.trajectories, problem.tlist,
                           **_compile_kwargs(kwargs))
    return program, cp


def bucket(cp, x):
    """The envelope bucket ``GrapeWrk`` takes for the pulse ``x``."""
    wrk = GrapeWrk.__new__(GrapeWrk)
    wrk.cp = cp
    wrk.upper_bounds = np.full(cp.n_controls * cp.n_timesteps, np.inf)
    wrk.lower_bounds = -wrk.upper_bounds
    return np.asarray(wrk._bucket_for(np.max(np.abs(x), axis=1)))


def evaluate(config, x, dtype):
    """``(J_T, gradient)`` of the program at pulses ``x (4, n_steps)``."""
    _, cp = compiled(config, x, dtype)
    fg = F.build_fg(cp, amp_max=bucket(cp, x))
    J, grad, aux = fg(x.reshape(-1))
    assert bool(aux["taylor_ok"])
    return float(aux["J_parts"][0]), grad.numpy().astype(np.float64)


@pytest.mark.parametrize("seed", [0, 1])
def test_complex128_against_the_reference(seed):
    """Both sides exact to the working precision: the Chebyshev series to
    1e-14 a step, the Taylor gradient to 1e-16, ``matrix_exp`` to a few
    ulps; 1e-10 in J_T and 1e-8 of the gradient's largest entry leave
    room for the 20 steps' rounding and nothing of a wrong term."""
    config = small()
    x = pulses(config, seed)
    J, g = evaluate(config, x, np.complex128)
    ref = Reference(config, kind.draw(config, 0), "cpu")
    J_ref, g_ref = ref.value_and_grad(x)
    assert 0.05 < J_ref < 1.0
    assert abs(J - J_ref) < 1e-10
    scale = np.max(np.abs(g_ref))
    assert scale > 1e-3
    assert np.max(np.abs(g - g_ref)) / scale < 1e-8


def test_complex64_within_the_cells_limits():
    """complex64 (the cell's precision) against complex128 at the same
    pulses: the gaps that the card's check holds the program to."""
    config = small()
    x = pulses(config, 2)
    J32, g32 = evaluate(config, x, np.complex64)
    J64, g64 = evaluate(config, x, np.complex128)
    assert abs(J32 - J64) < LIMITS["J_T_gap"]
    rel = np.max(np.abs(g32 - g64)) / np.max(np.abs(g64))
    assert rel < LIMITS["grad_gap"]


def _hand_orders(cp, amp_max, tol=1e-9):
    """The static order count: the smallest ``m`` with ``(‖μ‖/‖H‖) m
    (dt ‖H‖)^m / m! < tol``, plus two; ``‖H‖`` the 1-norm bound
    ``‖H0‖_1 + Σ_l amp_l ‖H_l‖_1`` (tol: the complex64 floor)."""
    h0 = max(np.abs(H).sum(axis=0).max() for H in np.asarray(cp.H0))
    ops = [np.abs(O).sum(axis=0).max() for O in np.asarray(cp.ops)[0]]
    h = h0 + sum(a * o for a, o in zip(amp_max, ops))
    bound = float(cp.tlist[1] - cp.tlist[0]) * h
    m, term = 0, max(ops) / h
    while True:
        m += 1
        term *= bound / m
        if m * term < tol:
            return m + 2


def test_counters_against_a_hand_count():
    """At dim 256 the Chebyshev-scan wrapper serves both directions: a
    gradient evaluation adds forward and adjoint, each ``terms × steps ×
    states``, and one Taylor pass; a functional-only evaluation the
    forward scan alone and no pass."""
    config = small(levels=16, n_steps=20)
    x = pulses(config, 3)
    _, cp = compiled(config, x, np.complex64)
    assert cp.dim == 256
    amp = bucket(cp, x)
    pds = F._prop_data(cp, amp)
    pd = pds["fw"]
    assert pd is pds["bw"] and F._cheby_kernel_enabled(cp, pd)
    # the table's width: the longer of the two directions' series
    alpha = 0.5 * pd["dE"] * float(cp.tlist[1] - cp.tlist[0])
    width = max(len(cheby_coeffs(alpha)), len(cheby_coeffs(-alpha)))
    orders = _hand_orders(cp, amp)
    K, N_T = 4, 20
    fg, f = F.build_fg(cp, amp_max=amp), F.build_f(cp, amp_max=amp)
    terms0 = hopper_cheby.terms["cheby_scan"]
    total0 = F.taylor_orders["total"]
    launches0 = dict(hopper_cheby.launches)
    fg(x.reshape(-1))
    assert hopper_cheby.terms["cheby_scan"] - terms0 == 2 * width * N_T * K
    assert F.taylor_orders["last"] == orders
    assert F.taylor_orders["total"] - total0 == orders
    fg(x.reshape(-1))
    f(x.reshape(-1))
    assert hopper_cheby.terms["cheby_scan"] - terms0 == 5 * width * N_T * K
    assert F.taylor_orders["total"] - total0 == 2 * orders
    # nothing launched on the CPU: the wrapper ran its plain version
    assert hopper_cheby.launches == launches0


def test_the_kind_adds_the_spectral_range():
    config = small(levels=6)
    program = kind.Program(config, kind.draw(config, 0))
    st = program.structure()
    H0 = program.H0[0]
    w = np.linalg.eigvalsh(H0)
    assert st["h0_range"] == pytest.approx([w[0], w[-1]])
    assert st["op_radii"] == pytest.approx(
        [np.linalg.norm(H, 2) for H in program.drives])
    assert st["d"] == 36 and st["K"] == 4 and st["N_T"] == 20
    assert math.isclose(st["dt"], 1.0 / 20)
    # the rest is the base kind's structure
    base = json.loads(json.dumps(st))
    for key in ("h0_range", "op_radii"):
        base.pop(key)
    assert set(base) == {"d", "G", "gs", "K", "T", "L", "N_T", "dt",
                         "h0_norm", "op_norms"}
