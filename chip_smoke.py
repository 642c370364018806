#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase taylor_order   # the device, the build
                                                 # and that phase alone
    python3 chip_smoke.py --phase cheby          # the dim-1024 Chebyshev
                                                 # paths, then that phase

Builds the CUDA kernels from ``grape_tpu_torch/csrc`` and holds each wrapper
against its plain PyTorch version on the card at the shapes of the paths
that use it and at a few other shapes, then drives the paths through
``compile_problem`` / ``build_fg`` and through up to five L-BFGS-B
iterations of ``optimize_problem`` / ``optimize`` each, and checks that
every evaluation went through the kernels:

- the two-transmon CZ gate (dim = 100, K = 4 trajectories under one shared
  generator, T = 4 control terms, N_T = 2000 steps);
- its robust ensemble (8 Hamiltonian samples x 4 basis states: K = 32
  trajectories in G = 8 generator groups of 4), and the same ensemble with
  one generator per trajectory (group size 1), whose propagator stream is
  past its storage budget and is formed again for the co-state chain;
- the factored Fréchet kernel at s = 1, where it builds the doubling from
  Krylov sets carried on to degree 31, at the benchmark cells' shapes
  (the CZ, 32 samples x 4, and a recompute window of 50 steps) against the
  dense traces in complex128, with the number of calls that took it;
- a robust ensemble of 1024 qutrits (d = 3, one generator per trajectory,
  T = 2 control terms, N_T = 400 steps) with ``gradient_method="taylor"``:
  the small-dimension forward kernel, the co-state chain over its
  propagators and the time-vectorized Taylor backward pass; beside it the
  CZ gate with the taylor gradient and the per-step backward pass at a
  small size;
- the two-transmon CZ at d = 32 (dim = 1024, K = 4, 4 control terms,
  N_T = 100 steps over a time of 1.0) under Chebyshev propagation with the
  taylor gradient: the
  Chebyshev-scan kernel forward and for the co-state chain, 27 terms per
  step, and the vectorized Taylor pass; beside it 64 basis states of the
  same register and the per-step extended-state gradgen at dim 256; the
  Taylor-order kernel (one launch an order of the pass at large d)
  against its plain version, the static-operator einsums it replaced and
  complex128, at dim 1024 (52 orders) and 256 and five ragged layouts,
  and the share of the orders it runs on the two Taylor cells' paths;
- the two kernels outside the optimizer: the per-trajectory forward scan
  without the propagator stream (``forward_scan_time``) and the probe of
  chained complex products (``python -m
  grape_tpu_torch.experiments.mxu_probe``, its kernel ``karatsuba_chain``
  at B = 512, 256 products, D = 100 and 128, float32 and TF32);
- the robust CZ ensemble under ``storage_mode="recompute"`` (40 segments
  of 50 steps; the forward and Fréchet kernels once per segment), against
  full storage, with peak memory at K = 32 and K = 512; the single-transmon
  qutrit gate with its guard running cost (BASELINE config 3) and the CZ
  with a leakage running cost (the ξ co-state chain); the CZ with its
  drives as nonlinear amplitudes ``A·sin(ε)``; the CZ with per-step
  observables handed to ``fw_prop_callback``;
- the kernels on non-Hermitian generators (Liouvillians: the dissipative
  two-level system, dim 4; the CZ at d = 3 with decay on both transmons,
  dim 81, alone, in 8 groups of 4 and as 32 distinct ones; 128 dissipative
  two-level systems) against their plain versions; the dissipative
  two-level system optimized through ``optimize`` against its golden J_T
  series and the dim-81 open CZ evaluated; the host modules around
  ``optimize`` (the X-gate, STIRAP, seeded dummy and subspace-gate
  problems with their golden series, ``optimize_or_load`` and
  ``propagate`` on the CZ); and ``optimize(..., profile_dir=...)`` on the
  CZ and the qutrits, with the card's busy share read from the trace.
  Every evaluation phase prints ``flops.fg_flops`` and the rate it implies;
- per-trajectory propagator settings: the CZ at dim 1024 with two basis
  states on the Chebyshev series and two on ExpProp (``Trajectory``
  attributes, ``fg_hetero``) against the two uniform builds, optimized
  three iterations, and the same split at dim 256 against the plain
  versions; Krotov's method (``optimize_krotov``) on the CZ at dim 100,
  N_T = 2000, on a per-trajectory ensemble and in the Krotov→GRAPE
  continuation of ``examples/07``;
- the kernels past the cluster kernels (d > 108): the wide propagator
  kernel against the global-scratch one, its plain version and
  ``torch.linalg.matrix_exp`` at d = 128, 256, 512 and 1024, the grid state
  scans against the one-block scans at d = 512 and 1024, and the CZ at 12
  levels a transmon (dim 144, N_T = 2000, taylor) evaluated against its
  plain version;
- the optimizer backends through ``optimize``: on the CZ ten iterations
  each of the native L-BFGS-B, scipy's L-BFGS-B and the device-resident
  L-BFGS loop at one and at five iterations a chunk, five of
  ``torch.optim.Adam``; on the 8 x 4 ensemble and the 1024 qutrits the
  host loop against the device loop; the backend ``"auto"`` takes; both
  loops on the 8 x 4 ensemble traced with ``profile_dir``;
- trajectory sharding over ``torch.distributed`` (``grape_tpu_torch.
  parallel``): a world of one on NCCL (the 8 x 4 ensemble sharded against
  ``build_fg``), then two ranks started as subprocesses of this script
  (``--parallel-rank``), both on the one card and reducing over gloo, on
  the 8 x 4 ensemble and the CZ against the single process, through three
  iterations of ``optimize(mesh=...)`` and a device-loop chunk, and the
  weak-scaling rows; two ranks sharing one card give no scaling number;
- the reference's last keywords on the CZ (``use_pallas=False``: no
  hand-written kernel, against the kernels; the three values of
  ``gradgen_pallas_precision``; ``prewarm_envelope=False``), the port's
  examples (``grape_tpu_torch.examples``: each ``main`` in complex64 with
  its own assertions), and BASELINE config 5 at the letter: 1024 samples
  of the CZ (K = 4096 in 1024 groups of 4, dim 100, N_T = 2000, recompute
  storage, gradgen, bounds +-0.5), the ensemble kernels at its segment
  shape against their plain versions, one evaluation through ``build_fg``
  and one through ``build_fg_multicall(n_calls=4)`` (the same J and
  gradient), and three iterations with ``eval_device_calls=4``.

Each phase prints one JSON line and raises on failure; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
with a non-zero code and prints no result.

Imports ``grape_tpu_torch`` (from the directory of this script) and nothing
of JAX or of the JAX package.
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# main-path configurations (BASELINE configs 4 and 5)
D_TRANSMON, N_STEPS, ITER_STOP = 10, 2000, 5
N_SAMPLES, N_BASIS = 8, 4
# the small-dimension path: 1024 Hamiltonian samples of a qutrit transmon
QUTRIT_SAMPLES, QUTRIT_T, QUTRIT_STEPS = 1024, 20.0, 400
SEED = 0

# published peaks of one H100 SXM (dense, no sparsity)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# kernel-vs-plain tolerances on the card (float32 arithmetic on both sides,
# sums taken in another order): states and propagators of unit scale after
# N_T = 2000 compounding steps, and the traces relative to their scale
TOL_STATE = 5e-5
TOL_TRJ = 2e-5
# the factored Frechet kernel against the dense one: two float32
# evaluations of the same function by different sums, each held to TOL_TRJ
# of the scale against its own plain version, so their sum of limits
TOL_ROUTES = 2 * TOL_TRJ


def emit(obj):
    print(json.dumps(obj), flush=True)


def require(cond, msg):
    """A check that survives ``python -O`` (unlike ``assert``)."""
    if not cond:
        raise AssertionError(msg)


def median_ms(fn, reps=5, runs=None):
    """Median CUDA-event time of ``fn`` in ms, after one warm call; the
    single times are appended to ``runs`` where one is given."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    if runs is not None:
        runs.extend(times)
    return float(np.median(times))


def windowed_ms(call, N_T, steps):
    """Median ms of ``call(n0, n1)`` over the time grid ``0..N_T`` in
    windows of ``steps`` steps, one call each, as recompute's segments call
    a wrapper on slices of its inputs."""
    def run():
        for n0 in range(0, N_T, steps):
            call(n0, min(n0 + steps, N_T))
    return median_ms(run, reps=3)


def under_load(fn, n):
    """SM clock (MHz) and power draw (W) as ``nvidia-smi`` reads them while
    ``n`` launches of ``fn`` are in flight: a card that holds its clock
    over a 50 ms kernel may not hold it over half a second of the same
    arithmetic."""
    for _ in range(n):
        fn()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.cuda.synchronize()
    sm, power = (float(v) for v in out.split(","))
    return {"launches_in_flight": n, "clocks_sm_mhz": sm,
            "power_draw_w": power}


def ptxas_summary(log):
    """Registers and spill bytes per kernel from the ``-Xptxas -v`` lines
    of a build log: ``{kernel: {"registers", "spill_stores",
    "spill_loads"}}`` (template arguments kept, namespaces dropped)."""
    import re

    out = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            # _ZN5grape24smalld_propagator_kernelILi4EEE... -> name<4>,
            # ...state_scan_kernelILb1ELi4EE... -> state_scan_kernel<1,4>
            mangled = m.group(1)
            k = re.search(r"\d+([a-z_]+kernel)((?:I(?:L[a-z]+\d+E)+E)?)",
                          mangled)
            args = [] if k is None else re.findall(r"L[a-z]+(\d+)E",
                                                   k.group(2))
            name = mangled if k is None else (
                k.group(1) + (f"<{','.join(args)}>" if args else ""))
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def max_abs(a, b):
    return float((a - b).abs().max())


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(flops, byts):
    """Least time in ms the card could take: operations at the float32
    peak outside the tensor cores, bytes at the memory rate."""
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = byts / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def frechet_needed_flops(d, K, T, N_T, s):
    """Float32 operations that ``trj[n,k,t] = tr(Op_t L(A_n, psi chi^+))``
    needs for the degree-16 Taylor polynomial at ``A / 2^s`` with ``s`` pair
    doublings, over ``N_T`` steps of one generator and ``K`` directions:
    the cheaper of the two evaluations the kernels run.

    The direction has rank one, so
    ``L = sum_{i+j<=15} c_{i+j+1} (A^i psi)(chi^+ A^j)`` has rank <= 16 and
    needs no dense product: 15 + 15 matrix-vector products build the two
    Krylov sets and 136 real-by-complex multiply-adds of vectors fold the
    coefficients in.  Each doubling ``L <- E_j L + L E_j`` doubles the
    rank: both sets are extended by ``E``, the degree-16 polynomial at
    ``A / 2^s``.  At s = 1 E is a polynomial in A, so ``E u_i = sum_k c_k
    u_{i+k}`` and ``E^+ y_i = sum_m D[i,m] v_m``: the sets run on to degree
    31 (16 + 16 more products) and are folded (16 * 17 + 392 more
    multiply-adds), no dense product; from s = 2 on E is formed (six dense
    products) and applied.  The traces are ``sum_ab Op_t[a,b] Z[b,a]``
    over ``Z = sum_r x_r w_r^+`` (``16 * 2^s`` outer products and ``T``
    matrix-sized multiply-adds).  Where that count exceeds the dense
    evaluation's (small d, large s), the dense one is taken.  The count is
    held equal to the routing model of the wrappers
    (``hopper_frechet.frechet_flops``), so that neither moves unseen.
    """
    from grape_tpu_torch.ops.hopper_frechet import (
        EXTENSION_S, frechet_flops,
    )

    mv = 8.0 * d * d            # complex (d, d) by (d,) product
    cmm = 8.0 * d ** 3          # complex (d, d) by (d, d) product
    gen = (4.0 * T + 2.0) * d * d   # A_n = -i dt (H0 + sum_t c_t Op_t)
    rank = 16 * 2 ** s
    folds = 136 + (16 * 17 + 392 if s == EXTENSION_S else 0)
    factored = gen + (6 * cmm if s > EXTENSION_S else 0.0) + K * (
        30 * mv                     # A^i psi, (A^+)^j chi, i, j = 1..15
        + folds * 4.0 * d           # y_i; at s = 1 E u_i and E^+ y_i
        + 2 * 16 * (2 ** s - 1) * mv    # E^p u_i, (E^+)^q y_i
        + rank * mv                 # Z = sum_r x_r w_r^+
        + T * mv                    # tr(Op_t Z)
    )
    dense = gen + (5 + s) * cmm + K * (
        (12 + 2 * s) * cmm + T * mv
    )
    model = min(frechet_flops(d, T, K, s).values())
    require(math.isclose(min(factored, dense), model, rel_tol=1e-12),
            f"the Frechet operation count {min(factored, dense)} and the "
            f"routing model {model} disagree at {(d, K, T, s)}")
    return N_T * min(factored, dense)


# the route launches of the propagator kernel and the state scans read with
# every count: [(the function that read them, {route: launches})]
ROUTE_READS = []


def zero_counts(*modules):
    for mod in modules:
        for key in mod.launches:
            mod.launches[key] = 0
        for key in getattr(mod, "route_launches", {}):
            mod.route_launches[key] = 0
        if hasattr(mod, "krylov_extension_calls"):
            mod.krylov_extension_calls = 0


def read_launches(*modules):
    """``(the wrappers' launch counts, the route launches)`` of all the
    modules, each in one dict."""
    out = {}
    routes = {}
    for mod in modules:
        out.update(mod.launches)
        routes.update(getattr(mod, "route_launches", {}))
    return out, routes


def read_counts(*modules):
    """The wrappers' launch counts; the route launches beside them are kept
    in ``ROUTE_READS`` under the calling function's name (every run read
    here must take the redesigned routes; a run that takes the old ones by
    the routing rule is read by :func:`read_launches` and checked where it
    runs)."""
    out, routes = read_launches(*modules)
    if routes:
        ROUTE_READS.append((sys._getframe(1).f_code.co_name, routes))
    return out


def counted(fn):
    """``fn`` with the number of its calls in ``.calls``."""
    def wrapped(*args, **kwargs):
        wrapped.calls += 1
        return fn(*args, **kwargs)
    wrapped.calls = 0
    return wrapped


def finite(*tensors):
    return all(bool(torch.isfinite(torch.view_as_real(x)).all())
               for x in tensors)


def random_group_inputs(rng, dev, d, G, gs, T, N_T, hscale, per_group):
    """Seeded random grouped kernel inputs on the card: Hermitian drifts
    and operators per group, a coefficient table (one, or one per group),
    slightly uneven time steps, unit-norm states and co-states."""
    c64 = lambda x: torch.tensor(x, dtype=torch.complex64, device=dev)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)

    def herm(*shape):
        A = rng.normal(size=shape) + 1j * rng.normal(size=shape)
        return (A + A.conj().swapaxes(-1, -2)) / np.sqrt(shape[-1])

    def unit(K):
        v = rng.normal(size=(K, d)) + 1j * rng.normal(size=(K, d))
        return c64(v / np.linalg.norm(v, axis=1, keepdims=True))

    shape = (G, N_T, T) if per_group else (N_T, T)
    return (c64(hscale * herm(G, d, d)), c64(herm(G, T, d, d)),
            f32(0.3 * rng.normal(size=shape)),
            f32(0.025 * (1 + 0.1 * rng.uniform(size=N_T))),
            unit(G * gs), unit(G * gs))


def frechet_inputs(rng, dev, d, G, gs, T, N_T, hscale, per_group):
    """``random_group_inputs`` with states and co-states that differ from
    step to step: ``(H0, ops, coeffs, dts, psis, chis)``, ``psis`` and
    ``chis`` ``(N_T, G * gs, d)``."""
    Hs, Os, cs, ts, p0, x0 = random_group_inputs(
        rng, dev, d, G, gs, T, N_T, hscale, per_group)
    psis = p0[None] * torch.exp(1j * torch.linspace(
        0, 3, N_T, device=dev))[:, None, None]
    chis = x0[None] * torch.exp(-0.5j * torch.linspace(
        0, 3, N_T, device=dev))[:, None, None]
    return Hs, Os, cs, ts, psis.contiguous(), chis.contiguous()


def frechet_forced(route, H0, ops, coeffs, dts, psis, chis, s):
    """The Frechet traces by the kernel of ``route`` (``"dense"`` or
    ``"factored"``), forced, for shared (``H0 (d, d)``) or grouped
    (``H0 (G, d, d)``) inputs, counted under the wrapper's key.  Checks and
    times only: the wrappers take ``hopper_frechet.frechet_route``."""
    from grape_tpu_torch.ops import hopper_frechet as hf

    if H0.ndim == 2:
        return hf._frechet_trace("frechet_trace_shared", H0[None], ops[None],
                                 coeffs, dts, psis, chis, s, route=route)
    return hf._frechet_trace("frechet_trace_pertraj", H0, ops, coeffs, dts,
                             psis, chis, s, route=route)


def max_step_norm(H0, ops, coeffs, dts):
    """``max_n dt_n ||H0 + sum_t c_nt Op_t||_1`` over the steps and the
    generator groups of grouped kernel inputs, on the card."""
    out = 0.0
    for g in range(H0.shape[0]):
        H = H0[g] + torch.einsum("nt,tij->nij", coeffs.to(H0.dtype), ops[g])
        out = max(out, float((dts * H.abs().sum(dim=-2).amax(dim=-1)).max()))
    return out


def frechet_extension_phase(cp, dev):
    """Phase ``frechet_extension``: the factored Frechet kernel at s = 1,
    where it forms the doubling's blocks from the Krylov sets carried on to
    degree 31 (the Krylov extension), at the benchmark cells' shapes: the
    CZ (one generator, K = 4, N_T = 2000), the 32-sample ensemble (G = 32
    groups of 4, N_T = 2000) and its recompute window (50 steps).  The
    pulses fill the cells' bounds of +-0.5, so the squaring count of both
    problems is 1, as in the cells (the squaring count follows the bounds;
    the pulses' own max dt ||H_n||_1 is near 2); one more CZ check at the
    top of s = 1's range, its steps lengthened to max dt ||H_n||_1 = 3.99
    (s = 2 from 4 on).  Each kernel result is held against the plain dense traces in
    complex128 on the card, and timed beside its bound; every call must
    count one Krylov extension.  Then the 32-sample ensemble's main path at
    the cells' bounds (gradgen, full storage and recompute in 40 segments,
    two L-BFGS-B iterations each): every Frechet call must take the
    factored kernel with the extension."""
    import grape_tpu_torch as gt
    from grape_tpu_torch.fg import _static_squarings
    from grape_tpu_torch.models import two_transmon_cz_ensemble_problem
    from grape_tpu_torch.ops import hopper_cheby, hopper_frechet as hf
    from grape_tpu_torch.ops import hopper_prop

    rng = np.random.default_rng(SEED + 18)
    ens = two_transmon_cz_ensemble_problem(n_samples=32, d=D_TRANSMON,
                                           n_steps=N_STEPS)
    cp_ens = gt.compile_problem(ens.trajectories, ens.tlist,
                                dtype=np.complex64, **ens.kwargs)
    c64 = lambda x: torch.tensor(np.ascontiguousarray(x),
                                 dtype=torch.complex64, device=dev)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    bounds = (0.5,) * cp.n_controls
    checks = []
    for name, cq, n_steps, top in (("cz", cp, N_STEPS, None),
                                   ("ensemble32", cp_ens, N_STEPS, None),
                                   ("ensemble32_window", cp_ens, 50, None),
                                   ("cz_top_of_s1", cp, N_STEPS, 3.99)):
        s = _static_squarings(cq, bounds)
        require(s == 1, f"{name}: squaring count {s} at the bounds, not 1")
        d, K, L = cq.dim, cq.n_traj, cq.n_controls
        H0 = c64(cq.H0 if cq.H0.ndim == 3 else cq.H0[None])
        ops = c64(cq.ops if cq.ops.ndim == 4 else cq.ops[None])
        G, T = ops.shape[0], ops.shape[1]
        gs = K // G
        eps = rng.uniform(-0.5, 0.5, size=(L, cq.n_timesteps))
        coeffs = f32(np.einsum("ntl,ln->nt", cq.M, eps)
                     + cq.Mfix)[:n_steps].contiguous()
        dts = f32(np.diff(cq.tlist))[:n_steps].contiguous()
        if top is not None:
            dts = dts * (top / max_step_norm(H0, ops, coeffs, dts))
        step_norm = max_step_norm(H0, ops, coeffs, dts)
        require(step_norm / 2 <= 2.0 + 1e-5,
                f"{name}: max dt ||H_n||_1 {step_norm} is past s = 1's range")

        def unit():
            v = (rng.normal(size=(n_steps, K, d))
                 + 1j * rng.normal(size=(n_steps, K, d)))
            return c64(v / np.linalg.norm(v, axis=-1, keepdims=True))

        psis, chis = unit(), unit()
        args = (H0, ops, coeffs, dts, psis, chis)
        require(hf.frechet_route(d, T, gs, s) == "factored",
                f"{name}: the Frechet traces must take the factored kernel")
        zero_counts(hf)
        call = lambda: hf._frechet_trace("frechet_trace_pertraj", *args, s)
        trj = call()
        torch.cuda.synchronize()
        require((hf.krylov_extension_calls,
                 hf.launches["frechet_trace_pertraj_factored"]) == (1, 1),
                f"{name}: the call did not count one Krylov extension")
        wide = [x.to(torch.complex128) for x in (H0, ops)] + [
            coeffs.double(), dts.double()] + [
            x.to(torch.complex128) for x in (psis, chis)]
        ref = hf._frechet_trace_plain(*wide, s)
        scale = max(float(ref.abs().max()), 1.0)
        err = float((trj.to(torch.complex128) - ref).abs().max()) / scale
        del ref, wide
        require(finite(trj) and err < TOL_TRJ,
                f"{name}: the Krylov extension disagrees with the complex128 "
                f"traces: {err} of the scale (tolerance {TOL_TRJ})")
        ms = median_ms(call, reps=5)
        flops = G * frechet_needed_flops(d, gs, T, n_steps, s)
        b_ms, by = bound(flops, nbytes(*args, trj))
        checks.append({
            "shape": name, "d": d, "G": G, "gs": gs, "T": T, "N_T": n_steps,
            "s": s, "max_step_norm": step_norm, "err_of_scale": err,
            "trj_scale": scale, "ms": ms, "bound_ms": b_ms, "bound_by": by,
            "gflop": flops / 1e9, "share_of_bound": b_ms / ms,
            "krylov_extension_calls": 1,
            "plan": hf.factored_plan(d, T, gs, s, n_steps * G)})
        del psis, chis, trj
    # the ensemble's main path at the cells' bounds: every count set to 0
    # just before and read just after
    mods = (hopper_prop, hf, hopper_cheby)
    main_path = []
    for storage in ({"storage_mode": "full"},
                    {"storage_mode": "recompute", "storage_segments": 40}):
        zero_counts(*mods)
        res = gt.optimize_problem(
            ens, iter_stop=2, dtype=np.complex64, print_iters=False,
            rethrow_exceptions=True, gradient_method="gradgen",
            lower_bound=-0.5, upper_bound=0.5, **storage)
        torch.cuda.synchronize()
        counts = read_counts(*mods)
        frechet = {k: v for k, v in counts.items() if "frechet" in k}
        n = frechet.get("frechet_trace_pertraj_factored", 0)
        require(n > 0 and hf.krylov_extension_calls == n
                and sum(frechet.values()) == n,
                f"ensemble main path {storage}: Frechet launches {frechet}, "
                f"Krylov extensions {hf.krylov_extension_calls}")
        main_path.append({**storage, "iterations": res.iter,
                          "fg_calls": res.fg_calls,
                          "frechet_launches": frechet,
                          "krylov_extension_calls":
                              hf.krylov_extension_calls})
    emit({"phase": "frechet_extension", "tol_of_scale": TOL_TRJ,
          "reference": "plain dense traces, complex128", "checks": checks,
          "ensemble_main_path": main_path})
    zero_counts(*mods)
    torch.cuda.synchronize()


def ensemble_kernel_phases(cp, s_main, rng, dev):
    """Phases ``kernel_check_ensemble`` and ``kernel_shapes_ensemble`` and
    the times of the ensemble wrappers at the ensemble path's shapes.

    Returns ``{name: {"err", "ms", "plain_ms", "flops", "bytes",
    "library_ms", ...}}`` for ``forward_scan_grouped``,
    ``forward_scan_pertraj``, ``chi_scan_grouped``, ``chi_scan_recompute``
    and ``frechet_trace_pertraj``."""
    from grape_tpu_torch.ops import hopper_frechet as hf
    from grape_tpu_torch.ops import hopper_prop as hp
    from grape_tpu_torch.ops import plain_versions

    c64 = lambda x: torch.tensor(x, dtype=torch.complex64, device=dev)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    d, K, N_T = cp.dim, cp.n_traj, cp.n_timesteps
    G, T, L = cp.H0.shape[0], cp.ops.shape[1], cp.n_controls
    gs = K // G
    H0g, opsg = c64(cp.H0), c64(cp.ops)
    # one generator per trajectory: the same operators repeated gs times
    H0k = H0g.repeat_interleave(gs, dim=0).contiguous()
    opsk = opsg.repeat_interleave(gs, dim=0).contiguous()
    eps = cp.guess_pulsevals + 0.02 * rng.normal(size=(L, N_T))
    coeffs = f32(np.einsum("ntl,ln->nt", cp.M, eps) + cp.Mfix)
    dts = f32(np.diff(cp.tlist))
    psi0 = c64(cp.psi0)
    chi0 = rng.normal(size=(K, d)) + 1j * rng.normal(size=(K, d))
    chi0 = c64(chi0 / np.linalg.norm(chi0, axis=1, keepdims=True))

    names = ("forward_scan_grouped", "forward_scan_pertraj",
             "chi_scan_grouped", "chi_scan_recompute",
             "frechet_trace_pertraj", "frechet_trace_pertraj_factored")
    out = {name: {"err": 0.0} for name in names}
    checks = []
    for s in sorted({s_main, 2}):
        require(hf.frechet_route(d, T, gs, s) == "factored"
                and hf.frechet_route(d, T, 1, s) == "factored",
                f"the ensemble's Frechet traces must take the factored "
                f"kernel at s={s}")
        st, U = hp.forward_scan_grouped(H0g, opsg, coeffs, dts, psi0, gs, s)
        st_k, U_k = hp.forward_scan_pertraj(H0k, opsk, coeffs, dts, psi0, s)
        st_w, U_w = hp.forward_scan_pertraj(H0k, opsk, coeffs, dts, psi0, s,
                                            with_propagators=False)
        chis = hp.chi_scan_grouped(U, chi0)
        chis_r, _ = hp.chi_scan_recompute(H0k, opsk, coeffs, dts, chi0, s)
        psis = st[:-1].contiguous()
        trj = hf.frechet_trace_pertraj(H0g, opsg, coeffs, dts, psis, chis, s,
                                       group_size=gs)
        trj_k = hf.frechet_trace_pertraj(H0k, opsk, coeffs, dts, psis, chis,
                                         s)
        torch.cuda.synchronize()
        trj_d = frechet_forced("dense", H0g, opsg, coeffs, dts, psis, chis,
                               s)
        trj_dk = frechet_forced("dense", H0k, opsk, coeffs, dts, psis, chis,
                                s)
        torch.cuda.synchronize()
        with plain_versions():
            st_p, U_p = hp.forward_scan_grouped(H0g, opsg, coeffs, dts, psi0,
                                                gs, s)
            chis_p = hp.chi_scan_grouped(U, chi0)
            trj_p = hf.frechet_trace_pertraj(H0g, opsg, coeffs, dts, psis,
                                             chis, s, group_size=gs)
            trj_dp = frechet_forced("dense", H0g, opsg, coeffs, dts, psis,
                                    chis, s)
        torch.cuda.synchronize()
        require(finite(st, U, st_k, U_k, st_w, chis, chis_r, trj, trj_k,
                       trj_d, trj_dk),
                f"an ensemble kernel output is not finite at s={s}")
        require(st.shape == (N_T + 1, K, d) and U.shape == (N_T, G, d, d)
                and U_k.shape == (N_T, K, d, d) and U_w is None
                and chis.shape == (N_T, K, d) and trj.shape == (N_T, K, T),
                "an ensemble kernel output has the wrong shape")
        # the per-trajectory versions on repeated operators compute the
        # grouped versions' function: held against the same plain results
        U_pk = U_p.repeat_interleave(gs, dim=1)
        scale = max(float(trj_p.abs().max()), 1.0)
        e = {
            "forward_scan_grouped": max(max_abs(st, st_p), max_abs(U, U_p)),
            "forward_scan_pertraj": max(max_abs(st_k, st_p),
                                        max_abs(U_k, U_pk),
                                        max_abs(st_w, st_p)),
            "chi_scan_grouped": max_abs(chis, chis_p),
            "chi_scan_recompute": max_abs(chis_r, chis_p),
            "frechet_trace_pertraj": max(max_abs(trj_d, trj_dp),
                                         max_abs(trj_dk, trj_dp)),
            "frechet_trace_pertraj_factored": max(max_abs(trj, trj_p),
                                                  max_abs(trj_k, trj_p)),
        }
        e_routes = max(max_abs(trj, trj_d), max_abs(trj_k, trj_dk))
        del U_k, U_pk, U_p, trj_d, trj_dk, trj_dp
        checks.append({"s": s, **e, "frechet_factored_vs_dense": e_routes,
                       "trj_scale": scale,
                       "trj_max": float(trj_p.abs().max())})
        for name, val in e.items():
            tol = TOL_TRJ * scale if name.startswith("frechet") else TOL_STATE
            require(val < tol, f"{name} disagrees with its plain version "
                    f"at s={s}: {val} (tolerance {tol})")
            out[name]["err"] = max(out[name]["err"], val)
        require(e_routes < TOL_ROUTES * scale, "the two Frechet kernels "
                f"disagree at s={s}: {e_routes}")
    emit({"phase": "kernel_check_ensemble",
          "shape": {"d": d, "G": G, "gs": gs, "K": K, "T": T, "N_T": N_T},
          "s_main_path": s_main, "tol_state": TOL_STATE,
          "tol_trj_of_scale": TOL_TRJ, "tol_routes_of_scale": TOL_ROUTES,
          "checks": checks})

    # ragged and edge shapes: group sizes that do not fill a scan block of
    # 4 or straddle two, one group, K not a multiple of 4, tiny and ragged
    # d, one step, a coefficient table per group; windows of 3 steps for
    # the versions that keep no propagator stream
    shape_checks = []
    for (d_, G_, gs_, T_, N_, s_, h_, pg_) in [
            (64, 3, 1, 2, 40, 1, 20.0, False),
            (5, 2, 3, 3, 9, 4, 100.0, True),
            (130, 2, 5, 1, 3, 1, 20.0, False),
            (2, 1, 1, 1, 1, 0, 5.0, True),
            (64, 1, 7, 2, 30, 0, 10.0, False),
            (100, 3, 4, 4, 10, 2, 40.0, True),
            (5, 5, 1, 2, 500, 0, 5.0, True)]:
        Hs, Os, cs, ts, p0, x0_ = random_group_inputs(
            rng, dev, d_, G_, gs_, T_, N_, h_, pg_)
        window_bytes = hp._WINDOW_BYTES

        def run():
            st, U = hp.forward_scan_grouped(Hs, Os, cs, ts, p0, gs_, s_)
            chis = hp.chi_scan_grouped(U, x0_)
            hp._WINDOW_BYTES = 3 * G_ * d_ * d_ * 8
            try:
                st_w, _ = hp.forward_scan_grouped(
                    Hs, Os, cs, ts, p0, gs_, s_, with_propagators=False)
                chis_r, _ = hp.chi_scan_recompute(Hs, Os, cs, ts, x0_,
                                                  s_)
            finally:
                hp._WINDOW_BYTES = window_bytes
            trj = hf.frechet_trace_pertraj(
                Hs, Os, cs, ts, st[:-1].contiguous(), chis, s_,
                group_size=gs_)
            return st, U, chis, st_w, chis_r, trj

        got = run()
        torch.cuda.synchronize()
        with plain_versions():
            want = run()
        scale = max(float(want[5].abs().max()), 1.0)
        errs = [max_abs(a, b) for a, b in zip(got, want)]
        errs[5] /= scale
        shape_checks.append({"d": d_, "G": G_, "gs": gs_, "T": T_, "N_T": N_,
                             "s": s_, "table_per_group": pg_,
                             "propagator_route": hp.propagator_route(d_),
                             "max_abs_err": max(errs)})
        require(max(errs) < TOL_TRJ, "ensemble kernels disagree with their "
                f"plain versions at shape {shape_checks[-1]}: {errs}")
    # identical operators in every group: the grouped and per-trajectory
    # wrappers must give what the shared-generator wrappers give
    d_, G_, gs_, T_, N_, s_ = 64, 2, 3, 2, 50, 1
    Hs, Os, cs, ts, p0, x0_ = random_group_inputs(
        rng, dev, d_, 1, G_ * gs_, T_, N_, 20.0, False)
    Hg, Og = Hs.repeat(G_, 1, 1), Os.repeat(G_, 1, 1, 1)
    Hk, Ok = Hs.repeat(G_ * gs_, 1, 1), Os.repeat(G_ * gs_, 1, 1, 1)
    st_s, U_s = hp.forward_scan_shared(Hs[0], Os[0], cs, ts, p0, s_)
    st_g, U_g = hp.forward_scan_grouped(Hg, Og, cs, ts, p0, gs_, s_)
    st_k, U_k = hp.forward_scan_pertraj(Hk, Ok, cs, ts, p0, s_)
    chis_s = hp.chi_scan_shared(U_s, x0_)
    chis_g = hp.chi_scan_grouped(U_g, x0_)
    psis = st_s[:-1].contiguous()
    trj_s = hf.frechet_trace_shared(Hs[0], Os[0], cs, ts, psis, chis_s, s_)
    trj_g = hf.frechet_trace_pertraj(Hg, Og, cs, ts, psis, chis_s, s_,
                                     group_size=gs_)
    trj_k = hf.frechet_trace_pertraj(Hk, Ok, cs, ts, psis, chis_s, s_)
    same = max(
        max_abs(st_g, st_s), max_abs(st_k, st_s),
        max_abs(U_g, U_s[:, None].expand_as(U_g)),
        max_abs(U_k, U_s[:, None].expand_as(U_k)),
        max_abs(chis_g, chis_s), max_abs(trj_g, trj_s),
        max_abs(trj_k, trj_s),
    )
    require(same < 1e-6, "with identical operators the grouped kernels "
            f"differ from the shared ones by {same}")
    emit({"phase": "kernel_shapes_ensemble", "tol": TOL_TRJ,
          "checks": shape_checks, "identical_operators_max_abs_diff": same})
    del st_s, U_s, st_g, U_g, st_k, U_k

    # ---- times at the ensemble path's shapes and squaring count ----------
    s = s_main
    st, U = hp.forward_scan_grouped(H0g, opsg, coeffs, dts, psi0, gs, s)
    chis = hp.chi_scan_grouped(U, chi0)
    psis = st[:-1].contiguous()
    calls = {
        "forward_scan_grouped": lambda: hp.forward_scan_grouped(
            H0g, opsg, coeffs, dts, psi0, gs, s),
        # as the per-trajectory path calls it at this size: no stream kept
        "forward_scan_pertraj": lambda: hp.forward_scan_pertraj(
            H0k, opsk, coeffs, dts, psi0, s, with_propagators=False),
        "chi_scan_grouped": lambda: hp.chi_scan_grouped(U, chi0),
        "chi_scan_recompute": lambda: hp.chi_scan_recompute(
            H0k, opsk, coeffs, dts, chi0, s),
        "frechet_trace_pertraj_factored": lambda: hf.frechet_trace_pertraj(
            H0g, opsg, coeffs, dts, psis, chis, s, group_size=gs),
        "frechet_trace_pertraj": lambda: frechet_forced(
            "dense", H0g, opsg, coeffs, dts, psis, chis, s),
    }
    heavy = ("forward_scan_pertraj", "chi_scan_recompute",
             "frechet_trace_pertraj")
    for name, fn in calls.items():
        out[name]["ms_runs"] = []
        out[name]["ms"] = median_ms(fn, reps=3 if name in heavy else 5,
                                    runs=out[name]["ms_runs"])
    with plain_versions():
        for name, fn in calls.items():
            out[name]["plain_ms"] = median_ms(
                fn, reps=1 if name in heavy else 3)
    out["forward_scan_grouped"]["propagators_only_ms"] = median_ms(
        lambda: hp.propagators(H0g, opsg, coeffs, dts, s))
    out["forward_scan_pertraj"]["with_propagators_ms"] = median_ms(
        lambda: hp.forward_scan_pertraj(H0k, opsk, coeffs, dts, psi0, s),
        reps=3)
    fact = out["frechet_trace_pertraj_factored"]
    fact["under_load"] = under_load(calls["frechet_trace_pertraj_factored"],
                                    20)
    # the time per item against the launch length: the wrapper on slices of
    # the time grid, launches of 400 items (recompute's windows), 2048 and
    # all 16000 at once
    fact["ms_by_items_per_launch"] = {
        ("all" if steps == N_T else str(steps * G)): windowed_ms(
            lambda n0, n1: hf.frechet_trace_pertraj(
                H0g, opsg, coeffs[n0:n1], dts[n0:n1], psis[n0:n1],
                chis[n0:n1], s, group_size=gs), N_T, steps)
        for steps in (400 // G, 2048 // G, N_T)}
    fact["group_size_1_ms"] = median_ms(
        lambda: hf.frechet_trace_pertraj(H0k, opsk, coeffs, dts, psis, chis,
                                         s), reps=3)
    out["frechet_trace_pertraj"]["group_size_1_ms"] = median_ms(
        lambda: frechet_forced("dense", H0k, opsk, coeffs, dts, psis, chis,
                               s), reps=1)
    with plain_versions():
        fact["group_size_1_plain_ms"] = median_ms(
            lambda: hf.frechet_trace_pertraj(H0k, opsk, coeffs, dts, psis,
                                             chis, s), reps=1)
    # the same launches with the cached device memory handed back first,
    # so that the kernel's scratch is a fresh allocation: fg evaluations
    # holding this kernel spread far more than its median alone does
    torch.cuda.empty_cache()
    fresh = fact["fresh_scratch_ms_runs"] = []
    median_ms(calls["frechet_trace_pertraj_factored"], reps=3, runs=fresh)
    trj = calls["frechet_trace_pertraj_factored"]()
    factored_shapes_phase(hf, rng, dev)
    frechet_routes_phase(hf, dev)

    cmm = 8.0 * d ** 3
    apply_flops = 8.0 * K * d * d
    out["forward_scan_grouped"].update(
        flops=N_T * (G * (6 + s) * cmm + apply_flops),
        bytes=nbytes(H0g, opsg, coeffs, dts, psi0, st, U))
    out["forward_scan_pertraj"].update(
        flops=N_T * (K * (6 + s) * cmm + apply_flops),
        bytes=nbytes(H0k, opsk, coeffs, dts, psi0, st))
    out["chi_scan_grouped"].update(
        flops=(N_T - 1) * apply_flops, bytes=nbytes(U, chi0, chis))
    out["chi_scan_recompute"].update(
        flops=N_T * K * (6 + s) * cmm + (N_T - 1) * apply_flops,
        bytes=nbytes(H0k, opsk, coeffs, dts, chi0, chis))
    # one function, one bound, whichever kernel computes it
    for route, name in (("dense", "frechet_trace_pertraj"),
                        ("factored", "frechet_trace_pertraj_factored")):
        out[name].update(
            flops=G * frechet_needed_flops(d, gs, T, N_T, s),
            bytes=nbytes(H0g, opsg, coeffs, dts, psis, chis, trj),
            algorithm_flops=N_T * G * hf.frechet_flops(d, T, gs, s)[route])
    del st, U, chis, psis, trj, calls
    torch.cuda.empty_cache()

    # yardstick for the propagator half of the forward scans: the library
    # call that computes the same exponentials (never used by the port).
    # One call on all N_T * K = 64000 matrices of the per-trajectory scan
    # reserves about 66 GB of workspace and faults with an illegal memory
    # access when that is not free (torch 2.11.0+cu128), so that scan's
    # yardstick is the sum over gs calls of N_T * G matrices each.
    co_c = coeffs.to(torch.complex64)
    a_c = (-1j * dts.to(torch.complex64))[:, None, None, None]
    for name, Hx, Ox, parts in (("forward_scan_grouped", H0g, opsg, 1),
                                ("forward_scan_pertraj", H0k, opsk, gs)):
        total = 0.0
        for steps in torch.arange(N_T, device=dev).chunk(parts):
            A_lib = (a_c[steps] * (Hx[None] + torch.einsum(
                "nt,gtij->ngij", co_c[steps], Ox))).reshape(-1, d, d)
            total += median_ms(lambda: torch.linalg.matrix_exp(A_lib),
                               reps=3)
            shape = tuple(A_lib.shape)
            del A_lib
            torch.cuda.empty_cache()
        out[name]["library_ms"] = total
        out[name]["library_call"] = (
            f"torch.linalg.matrix_exp on {shape}, {parts} call(s) summed: "
            "the propagators only")
    for name in ("chi_scan_grouped", "chi_scan_recompute",
                 "frechet_trace_pertraj", "frechet_trace_pertraj_factored"):
        out[name]["library_ms"] = None
    return out


def factored_shapes_phase(hf, rng, dev):
    """Phase ``kernel_shapes_factored``: the factored Frechet kernel against
    its plain version and against the dense kernel at ragged shapes, each
    forced onto the factored route: the matrix in global memory (d = 160,
    at s = 0 and at s = 1, the Krylov extension through generic pointers,
    and d = 200 with the sets too), the sets in global memory (d = 100,
    s = 4), the chunk of directions cut to fit (gs = 7 at s = 3: chunks of
    2, 2, 2 and 1), tiny d, one step, a table per group."""
    from grape_tpu_torch.ops import plain_versions

    checks = []
    for (d_, G_, gs_, T_, N_, s_, h_, pg_) in [
            (160, 2, 3, 2, 12, 0, 10.0, False),
            (160, 1, 2, 2, 6, 1, 10.0, False),
            (200, 1, 2, 1, 4, 3, 60.0, True),
            (100, 2, 5, 3, 10, 4, 100.0, False),
            (37, 1, 7, 1, 9, 3, 60.0, False),
            (5, 3, 2, 2, 50, 1, 20.0, True),
            (2, 1, 1, 1, 1, 0, 5.0, False),
            (130, 3, 1, 4, 20, 2, 40.0, True)]:
        Hs, Os, cs, ts, psis, chis = frechet_inputs(
            rng, dev, d_, G_, gs_, T_, N_, h_, pg_)

        def run(route):
            return frechet_forced(route, Hs, Os, cs, ts, psis, chis, s_)

        got = run("factored")
        torch.cuda.synchronize()
        dense = run("dense")
        with plain_versions():
            want = run("factored")
        torch.cuda.synchronize()
        scale = max(float(want.abs().max()), 1.0)
        plan = hf.factored_plan(d_, T_, gs_, s_, N_ * G_)
        e = max_abs(got, want) / scale
        e_dense = max_abs(got, dense) / scale
        checks.append({"d": d_, "G": G_, "gs": gs_, "T": T_, "N_T": N_,
                       "s": s_, "table_per_group": pg_, "plan": plan,
                       "max_abs_err": e, "vs_dense": e_dense})
        require(finite(got) and e < TOL_TRJ and e_dense < TOL_ROUTES,
                f"the factored Frechet kernel disagrees at {checks[-1]}")
    require(any(not c["plan"]["matrix_shared"] for c in checks)
            and any(not c["plan"]["sets_shared"] for c in checks)
            and any(c["plan"]["chunk"] < min(c["gs"], 4) for c in checks),
            "the ragged shapes must reach every layout of the working set")
    emit({"phase": "kernel_shapes_factored", "tol": TOL_TRJ,
          "tol_vs_dense": TOL_ROUTES, "checks": checks})


def frechet_routes_phase(hf, dev):
    """Phase ``frechet_routes``: both Frechet kernels, each forced, timed on
    the same inputs at the shapes where ``frechet_route`` decides between
    them: d = 100 with the CZ's T = 4 at s = 0..7 for a group of 4
    directions (K3's shape, 2000 steps; the rule's crossing lies between
    s = 5 and 6) and at s = 0, 3, 5 for 4 groups of one, and at d = 3 the shapes of config 3 (one generator, K = 2, T = 2,
    400 steps) and of the qutrits' gradgen evaluation (1024 groups of one,
    T = 2, 400 steps).  Beside each, the route the rule takes, the factored
    kernel's layout and the two kernels' agreement (< ``TOL_ROUTES`` of the
    traces' scale)."""
    rng = np.random.default_rng(SEED + 6)
    cases = ([(100, 1, 4, 4, 2000, s, 10.0) for s in range(8)]
             + [(100, 4, 1, 4, 2000, s, 10.0) for s in (0, 3, 5)]
             + [(3, 1, 2, 2, 400, 0, 5.0), (3, 1024, 1, 2, 400, 0, 5.0)])
    rows = []
    for (d, G, gs, T, N, s, h) in cases:
        Hs, Os, cs, ts, psis, chis = frechet_inputs(
            rng, dev, d, G, gs, T, N, h, False)
        got, ms = {}, {}
        for route in ("dense", "factored"):
            fn = (lambda r=route: frechet_forced(r, Hs, Os, cs, ts, psis,
                                                 chis, s))
            got[route] = fn()
            ms[route] = median_ms(fn, reps=3)
        scale = max(float(got["dense"].abs().max()), 1.0)
        e = max_abs(got["factored"], got["dense"]) / scale
        rule = hf.frechet_route(d, T, gs, s)
        faster = min(ms, key=ms.get)
        rows.append({
            "d": d, "G": G, "gs": gs, "T": T, "N_T": N, "s": s,
            "dense_ms": ms["dense"], "factored_ms": ms["factored"],
            "route": rule, "faster": faster,
            "gflop": {r: N * G * f / 1e9 for r, f in
                      hf.frechet_flops(d, T, gs, s).items()},
            "plan": hf.factored_plan(d, T, gs, s, N * G),
            "factored_vs_dense": e})
        require(finite(got["dense"], got["factored"]) and e < TOL_ROUTES,
                f"the two Frechet kernels disagree at {rows[-1]}")
    emit({"phase": "frechet_routes", "tol_of_scale": TOL_ROUTES,
          "rule_takes_the_faster": sum(r["route"] == r["faster"]
                                       for r in rows),
          "of": len(rows), "rows": rows})


def fg_against_plain(fg, x0, what, tol_J=1e-5):
    """One evaluation through the kernels and one with the plain versions
    forced, on the same pulse: ``(J, g, aux, |ΔJ|, gradient difference as
    a share of its max)``, held to ``tol_J`` and 2e-3."""
    from grape_tpu_torch.ops import plain_versions

    J, g, aux = fg(x0)
    torch.cuda.synchronize()
    with plain_versions():
        J_p, g_p, _ = fg(x0)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(g).all()) and math.isfinite(float(J))
            and bool(aux["chi_ok"]), f"{what}: fg output is not finite")
    dJ = abs(float(J) - float(J_p))
    dg = max_abs(g, g_p) / float(g_p.abs().max())
    require(dJ < tol_J,
            f"{what}: J kernels {float(J)} vs plain {float(J_p)}")
    require(dg < 2e-3, f"{what}: gradient differs by {dg} of its max")
    return J, g, aux, dJ, dg


def timed_ms(fn, reps):
    """Host-clock ms per call of ``fn`` over ``reps`` calls, synchronised."""
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def fg_breakdown(fg, x, reps=3, names=None, label=None):
    """Where one evaluation's time on the card goes: CUDA events around the
    whole evaluation and around every kernel wrapper and the vectorized
    Taylor pass inside it (the names ``grape_tpu_torch.fg`` calls them by
    are wrapped for the duration; ``names`` and ``label(name, args,
    kwargs)`` choose others and how their spans are named).  Medians over
    ``reps`` evaluations, ms; ``glue`` is the rest of the span: coefficient
    tables, J_T, χ(T) by autograd, the contraction with dM, and every gap
    in which the card waits for the host."""
    import grape_tpu_torch.fg as F

    names = names or [
        "forward_scan_shared", "forward_scan_grouped", "forward_scan_pertraj",
        "forward_scan_smalld", "chi_scan_shared", "chi_scan_grouped",
        "chi_scan_recompute", "frechet_trace_shared", "frechet_trace_pertraj",
        "cheby_scan", "_backward_vectorized", "chi_window_plain",
        "_xi_sources",
    ]
    spans = []

    def kernel_label(name, args, kwargs):
        if name == "cheby_scan":  # one wrapper, two directions
            return name + ("_adjoint" if kwargs.get("adjoint")
                           else "_forward")
        return name

    label = label or kernel_label

    def shim(name, fn):
        def wrapped(*args, **kwargs):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kwargs)
            b.record()
            spans.append((label(name, args, kwargs), a, b))
            return out
        return wrapped

    originals = {name: getattr(F, name) for name in names}
    for name, fn in originals.items():
        setattr(F, name, shim(name, fn))
    runs = []
    try:
        fg(x)
        torch.cuda.synchronize()
        for _ in range(reps):
            spans.clear()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fg(x)
            b.record()
            torch.cuda.synchronize()
            parts = {}
            for name, e0, e1 in spans:
                parts[name] = parts.get(name, 0.0) + e0.elapsed_time(e1)
            total = a.elapsed_time(b)
            parts["glue"] = total - sum(parts.values())
            parts["total"] = total
            runs.append(parts)
    finally:
        for name, fn in originals.items():
            setattr(F, name, fn)
    return {key: float(np.median([r[key] for r in runs])) for key in runs[0]}


def smalld_kernel_phase(cp, s_main, rng, dev):
    """Phase ``kernel_check_smalld`` and the times of
    ``forward_scan_smalld`` at the qutrit ensemble's shapes.  Returns its
    entry for the ``kernels`` line (without the launch count)."""
    from grape_tpu_torch.ops import hopper_prop as hp
    from grape_tpu_torch.ops import plain_versions

    def c64(x):
        return torch.tensor(np.ascontiguousarray(x), dtype=torch.complex64,
                            device=dev)

    def f32(x):
        return torch.tensor(np.ascontiguousarray(x), dtype=torch.float32,
                            device=dev)

    d, K, N_T = cp.dim, cp.n_traj, cp.n_timesteps
    T, L = cp.ops.shape[1], cp.n_controls
    H0, ops, psi0 = c64(cp.H0), c64(cp.ops), c64(cp.psi0)
    eps = cp.guess_pulsevals + 0.02 * rng.normal(size=(L, N_T))
    coeffs = f32(np.einsum("ntl,ln->nt", cp.M, eps) + cp.Mfix)
    dts = f32(np.diff(cp.tlist))
    err = 0.0
    checks = []
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for s in sorted({s_main, 2}):
        st, U = hp.forward_scan_smalld(H0, ops, coeffs, dts, psi0, s,
                                       with_propagators=True)
        st_only = hp.forward_scan_smalld(H0, ops, coeffs, dts, psi0, s)
        with hp._forced_smalld_route("pair"):
            st_2, U_2 = hp.forward_scan_smalld(H0, ops, coeffs, dts, psi0, s,
                                               with_propagators=True)
            st_2only = hp.forward_scan_smalld(H0, ops, coeffs, dts, psi0, s)
        torch.cuda.synchronize()
        with plain_versions():
            st_p, U_p = hp.forward_scan_smalld(H0, ops, coeffs, dts, psi0, s,
                                               with_propagators=True)
        require(finite(st, U, st_only), f"smalld output not finite at s={s}")
        require(st.shape == (N_T + 1, K, d) and U.shape == (N_T, K, d, d)
                and st_only.shape == st.shape,
                "smalld output has the wrong shape")
        e = {"states": max_abs(st, st_p), "U": max_abs(U, U_p),
             "states_without_U": max_abs(st_only, st_p)}
        e_pair = {"states": max_abs(st_2, st_p), "U": max_abs(U_2, U_p),
                  "states_without_U": max_abs(st_2only, st_p)}
        # the same arithmetic (csrc/smalld_expm.cuh) in both kernels
        fused_vs_pair = max(max_abs(st, st_2), max_abs(U, U_2),
                            max_abs(st_only, st_2only))
        checks.append({"s": s, **e, "pair_kernels": e_pair,
                       "fused_vs_pair_max_abs_diff": fused_vs_pair})
        require(max(*e.values(), *e_pair.values()) < TOL_STATE,
                "forward_scan_smalld disagrees with its plain version at "
                f"s={s}: fused {e}, pair {e_pair}")
        require(fused_vs_pair < TOL_TRJ, "the fused and two-launch small-d "
                f"kernels disagree by {fused_vs_pair} at s={s}")
        err = max(err, *e.values())

    def herm(*shape):
        A = rng.normal(size=shape) + 1j * rng.normal(size=shape)
        return 0.5 * (A + A.conj().swapaxes(-1, -2))

    # ragged shapes: every template instance, K at, just past and far from
    # a multiple of the block sizes, one step, one term, squarings; the
    # last with windows of 3 steps where no stream is kept
    shape_checks = []
    for (d_, K_, T_, N_, s_, h_) in [(2, 128, 1, 1, 0, 1.0),
                                     (3, 129, 2, 7, 1, 2.0),
                                     (4, 1000, 1, 33, 2, 4.0),
                                     (4, 4096, 3, 20, 0, 1.0),
                                     (2, 4096, 2, 1, 3, 8.0),
                                     (3, 1000, 1, 1, 0, 1.0),
                                     (4, 129, 2, 50, 1, 2.0)]:
        Hs, Os = c64(h_ * herm(K_, d_, d_)), c64(herm(K_, T_, d_, d_))
        cs = f32(0.3 * rng.normal(size=(N_, T_)))
        ts = f32(0.05 * (1 + 0.2 * rng.uniform(size=N_)))
        p0 = rng.normal(size=(K_, d_)) + 1j * rng.normal(size=(K_, d_))
        p0 = c64(p0 / np.linalg.norm(p0, axis=1, keepdims=True))
        window_bytes = hp._WINDOW_BYTES

        def run():
            st, U = hp.forward_scan_smalld(Hs, Os, cs, ts, p0, s_,
                                           with_propagators=True)
            hp._WINDOW_BYTES = 3 * K_ * d_ * d_ * 8
            try:
                st_w = hp.forward_scan_smalld(Hs, Os, cs, ts, p0, s_)
            finally:
                hp._WINDOW_BYTES = window_bytes
            return st, U, st_w

        got = run()
        with hp._forced_smalld_route("pair"):
            got_pair = run()
        torch.cuda.synchronize()
        with plain_versions():
            want = run()
        worst = max(max_abs(a, b) for a, b in zip(got, want))
        worst_pair = max(max_abs(a, b) for a, b in zip(got_pair, want))
        shape_checks.append({"d": d_, "K": K_, "T": T_, "N_T": N_, "s": s_,
                             "max_abs_err": worst,
                             "pair_max_abs_err": worst_pair,
                             "plan": hp.smalld_route(d_, K_, N_, sms)})
        require(max(worst, worst_pair) < TOL_TRJ, "forward_scan_smalld "
                "disagrees with its plain version at shape "
                f"{shape_checks[-1]}")
    emit({"phase": "kernel_check_smalld",
          "shape": {"d": d, "K": K, "T": T, "N_T": N_T},
          "s_main_path": s_main, "tol_state": TOL_STATE, "checks": checks,
          "tol_shapes": TOL_TRJ, "shape_checks": shape_checks})

    s = s_main
    st, U = hp.forward_scan_smalld(H0, ops, coeffs, dts, psi0, s,
                                   with_propagators=True)
    out = {"err": err, "ms_runs": []}
    out["ms"] = median_ms(
        lambda: hp.forward_scan_smalld(H0, ops, coeffs, dts, psi0, s,
                                       with_propagators=True),
        reps=20, runs=out["ms_runs"])
    out["without_propagators_ms"] = median_ms(
        lambda: hp.forward_scan_smalld(H0, ops, coeffs, dts, psi0, s),
        reps=20)
    with hp._forced_smalld_route("pair"):
        out["pair_ms"] = median_ms(
            lambda: hp.forward_scan_smalld(H0, ops, coeffs, dts, psi0, s,
                                           with_propagators=True), reps=20)
        out["pair_without_propagators_ms"] = median_ms(
            lambda: hp.forward_scan_smalld(H0, ops, coeffs, dts, psi0, s),
            reps=20)
    out["plan"] = hp.smalld_route(d, K, N_T, sms)
    with plain_versions():
        out["plain_ms"] = median_ms(
            lambda: hp.forward_scan_smalld(H0, ops, coeffs, dts, psi0, s,
                                           with_propagators=True), reps=3)
    # the large-d per-trajectory kernels on the same inputs: the route for
    # K < 128, and the honest comparison
    out["forward_scan_pertraj_ms"] = median_ms(
        lambda: hp.forward_scan_pertraj(H0, ops, coeffs, dts, psi0, s),
        reps=3)
    # yardstick for the propagator half: the library call that computes the
    # same N_T * K exponentials (never used by the port)
    A_lib = ((-1j * dts.to(torch.complex64))[:, None, None, None] * (
        H0[None] + torch.einsum("nt,ktij->nkij", coeffs.to(torch.complex64),
                                ops))).reshape(-1, d, d)
    out["library_ms"] = median_ms(lambda: torch.linalg.matrix_exp(A_lib),
                                  reps=3)
    out["library_call"] = (f"torch.linalg.matrix_exp on {tuple(A_lib.shape)}"
                           ": the propagators only")
    del A_lib
    # per item: the generator (T real-by-complex axpys and a scaling), the
    # 6 + s complex products and the matrix-vector product
    out["flops"] = N_T * K * ((6 + s) * 8.0 * d ** 3
                              + (4.0 * T + 2.0) * d * d + 8.0 * d * d)
    out["bytes"] = nbytes(H0, ops, coeffs, dts, psi0, st, U)
    return out


def smalld_routes_phase(cp, dev):
    """Phase ``smalld_routes``: the fused small-dimension kernel
    (``csrc/smalld_fused.cu``) and the two-launch pair
    (``csrc/smalld_scan.cu``) forced in turn on the same inputs, with and
    without the propagator stream: the qutrit ensemble's shape (d = 3,
    K = 1024, N_T = 400) and four others (d 2..4, K 128..4096).  Each
    shape names the faster kernel beside the rule's, which must be it."""
    from grape_tpu_torch.ops import hopper_prop as hp

    rng = np.random.default_rng(SEED + 11)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    c64 = lambda x: torch.tensor(np.ascontiguousarray(x),
                                 dtype=torch.complex64, device=dev)
    f32 = lambda x: torch.tensor(np.ascontiguousarray(x),
                                 dtype=torch.float32, device=dev)

    def herm(*shape):
        A = rng.normal(size=shape) + 1j * rng.normal(size=shape)
        return 0.5 * (A + A.conj().swapaxes(-1, -2))

    L = cp.n_controls
    qutrits = (c64(cp.H0), c64(cp.ops), f32(
        np.einsum("ntl,ln->nt", cp.M, cp.guess_pulsevals) + cp.Mfix),
        f32(np.diff(cp.tlist)), c64(cp.psi0))
    rows = []
    for name, d, K, N_T in [("qutrits", cp.dim, cp.n_traj, cp.n_timesteps),
                            ("d2_K128", 2, 128, 400),
                            ("d3_K130", 3, 130, 400),
                            ("d4_K1000", 4, 1000, 400),
                            ("d4_K4096", 4, 4096, 100)]:
        if name == "qutrits":
            args = qutrits
        else:
            p0 = rng.normal(size=(K, d)) + 1j * rng.normal(size=(K, d))
            args = (c64(2.0 * herm(K, d, d)), c64(herm(K, L, d, d)),
                    f32(0.3 * rng.normal(size=(N_T, L))),
                    f32(0.05 * (1 + 0.2 * rng.uniform(size=N_T))),
                    c64(p0 / np.linalg.norm(p0, axis=1, keepdims=True)))
        plan = hp.smalld_route(d, K, N_T, sms)
        row = {"shape": name, "d": d, "K": K, "N_T": N_T,
               "rule": plan["route"], "plan": plan}
        outs = {}
        for route in ("fused", "pair"):
            with hp._forced_smalld_route(route):
                for keep in (True, False):
                    call = lambda: hp.forward_scan_smalld(
                        *args, 0, with_propagators=keep)
                    outs[route, keep] = call()
                    torch.cuda.synchronize()
                    row[f"{route}_ms" + ("" if keep else "_without_U")] = (
                        median_ms(call, reps=10))
        diff = max(max_abs(outs["fused", True][0], outs["pair", True][0]),
                   max_abs(outs["fused", True][1], outs["pair", True][1]),
                   max_abs(outs["fused", False], outs["pair", False]))
        row["fused_vs_pair_max_abs_diff"] = diff
        require(diff < TOL_TRJ, f"smalld_routes: the kernels disagree at "
                f"{name} by {diff}")
        row["faster"] = min(("fused", "pair"), key=lambda r: row[f"{r}_ms"]
                            + row[f"{r}_ms_without_U"])
        require(row["faster"] == plan["route"], f"smalld_routes: the rule "
                f"takes {plan['route']} at {name}, the faster is "
                f"{row['faster']}")
        rows.append(row)
    emit({"phase": "smalld_routes", "tol": TOL_TRJ, "sm_count": sms,
          "shapes": rows})


def smalld_and_taylor_paths(cz_problem, cz_fg_ms, g_cz_gradgen, rng, dev):
    """The third path and its companions: phases ``kernel_check_smalld``,
    ``fg_smalld``, ``optimize_smalld`` (1024 qutrits, taylor), then
    ``fg_taylor_cz`` (the CZ gate with the taylor gradient) and
    ``per_step_fallback``; each counted run with the launch counts set to 0
    just before and read just after.  Returns ``(K7's entry for the kernels
    line, the qutrit path's counts, the CZ-taylor counts, the counts of the
    qutrits' one gradgen evaluation)``."""
    import grape_tpu_torch as gt
    from grape_tpu_torch.fg import (
        _reuse_U_enabled, _smalld_enabled, _static_squarings,
        _vec_gradgen_enabled, _vectorized_taylor_orders,
    )
    from grape_tpu_torch.functionals import J_T_sm
    from grape_tpu_torch.models import transmon_ensemble_trajectories
    from grape_tpu_torch.ops import hopper_cheby, hopper_frechet, hopper_prop

    trajs = transmon_ensemble_trajectories(QUTRIT_SAMPLES, d=3,
                                           T=QUTRIT_T, seed=SEED)
    tlist = np.linspace(0, QUTRIT_T, QUTRIT_STEPS + 1)
    kw = dict(J_T=J_T_sm, dtype=np.complex64)
    cp = gt.compile_problem(trajs, tlist, gradient_method="taylor", **kw)
    d, K, N_T, L = cp.dim, cp.n_traj, cp.n_timesteps, cp.n_controls
    require((d, K, cp.ops.shape[1], L, N_T) == (3, 1024, 2, 2, 400)
            and cp.device.type == "cuda" and cp.psi0.dtype == np.complex64
            and not cp.shared_generator and cp.H0.shape[0] == K,
            "unexpected shape of the qutrit ensemble")
    require(_smalld_enabled(cp) and _reuse_U_enabled(cp)
            and cp.gradient_method == "taylor",
            "the qutrit ensemble must take the small-dimension route with "
            "stored propagators")
    s_q = _static_squarings(cp)
    n_orders = _vectorized_taylor_orders(cp)
    require(n_orders is not None, "no static Taylor order for the qutrits")
    k7 = smalld_kernel_phase(cp, s_q, rng, dev)
    smalld_routes_phase(cp, dev)
    x0 = cp.guess_pulsevals.reshape(-1)

    # ---- side checks, before the counted run ------------------------------
    # (a) the gradgen gradient of the same problem: K7 forward, the
    # per-trajectory Frechet kernel backward (the dense one: at d = 3 it
    # needs fewer operations); the counted run of that kernel
    cp_gg = gt.compile_problem(trajs, tlist, gradient_method="gradgen", **kw)
    require(_smalld_enabled(cp_gg) and _vec_gradgen_enabled(cp_gg),
            "the gradgen cross-check must take the small-dimension route")
    fg_gg = gt.build_fg(cp_gg)
    zero_counts(hopper_prop, hopper_frechet, hopper_cheby)
    J_gg, g_gg, _ = fg_gg(x0)
    torch.cuda.synchronize()
    counts_gg = {k: v for k, v in read_counts(
        hopper_prop, hopper_frechet, hopper_cheby).items() if v}
    require(counts_gg == {"forward_scan_smalld": 1, "chi_scan_grouped": 1,
                          "frechet_trace_pertraj": 1},
            f"gradgen on the qutrits launched {counts_gg}")
    gg_ms = timed_ms(lambda: fg_gg(x0), 3)
    # (b) complex64 through the kernels against complex128 (Pade-13), both
    # on the card, on the first 128 samples: the smallest cut that still
    # takes the small-dimension route
    cut = 128
    cp64, cp128 = (
        gt.compile_problem(trajs[:cut], tlist, gradient_method="taylor",
                           J_T=J_T_sm, dtype=dt)
        for dt in (np.complex64, np.complex128)
    )
    require(_smalld_enabled(cp64) and not _smalld_enabled(cp128),
            "the cut must take the small-dimension route in complex64 only")
    Js, gs_, aux_s = gt.build_fg(cp64)(x0)
    Jr, gr, aux_r = gt.build_fg(cp128)(x0)
    dJs = abs(float(Js) - float(Jr))
    dgs = float((gs_.double() - gr).abs().max() / gr.abs().max())
    require(dJs < 1e-5 and dgs < 2e-3 and bool(aux_s["taylor_ok"])
            and bool(aux_r["taylor_ok"]),
            f"qutrit cut: dJ {dJs}, dgrad {dgs} against complex128")

    # ---- the counted run: fg, then five iterations ------------------------
    zero_counts(hopper_prop, hopper_frechet, hopper_cheby)
    fg = gt.build_fg(cp)
    J, g, aux, dJ, dg = fg_against_plain(fg, x0, "fg_smalld")
    n_fg = 1
    require(g.shape == (L * N_T,) and g.device.type == "cuda"
            and aux["psi_T"].shape == (K, d) and bool(aux["taylor_ok"]),
            "fg_smalld output has the wrong shape or device, or the Taylor "
            "series did not converge")
    d_gg = max_abs(g, g_gg) / float(g_gg.abs().max())
    require(abs(float(J) - float(J_gg)) < 1e-5 and d_gg < 1e-3,
            f"taylor and gradgen disagree on the qutrits: gradient {d_gg} "
            "of its max")
    reps = 5
    fg_ms = timed_ms(lambda: fg(x0), reps)
    n_fg += reps
    parts = fg_breakdown(fg, x0)
    n_fg += 4
    # the same pass with its small products as batched matrix products (the
    # form it takes above d = 4), in turns: batched, elementwise, ...
    import grape_tpu_torch.fg as F
    threshold = F._ELEMENTWISE_MAX_DIM
    taylor_pass_ms = {"batched_matmul": [], "elementwise": []}
    try:
        for _ in range(2):
            for name, limit in (("batched_matmul", 0),
                                ("elementwise", threshold)):
                F._ELEMENTWISE_MAX_DIM = limit
                taylor_pass_ms[name].append(
                    fg_breakdown(fg, x0, reps=2)["_backward_vectorized"])
                n_fg += 3
    finally:
        F._ELEMENTWISE_MAX_DIM = threshold
    Jf, _ = gt.build_f(cp)(x0)
    n_f = 1
    require(abs(float(Jf) - float(J)) < 1e-6,
            "build_f disagrees with build_fg on the qutrits")
    emit({"phase": "fg_smalld", "J": float(J), "grad_norm": float(g.norm()),
          "ms_per_eval": fg_ms, "flop_rate": flop_rate(cp, fg_ms),
          "device_ms_by_part": parts,
          "taylor_pass_ms_by_product_form": taylor_pass_ms,
          "J_abs_diff_vs_plain": dJ, "grad_diff_of_max_vs_plain": dg,
          "squarings": s_q, "taylor_orders": n_orders,
          "taylor_ok": bool(aux["taylor_ok"]), "dtype": "complex64",
          "gradgen": {"J": float(J_gg), "ms_per_eval": gg_ms,
                      "flop_rate": flop_rate(cp_gg, gg_ms),
                      "grad_diff_of_max_vs_taylor": d_gg,
                      "launches_one_eval": counts_gg},
          "cut_vs_complex128": {"samples": cut, "J_complex64": float(Js),
                                "J_complex128": float(Jr), "J_abs_diff": dJs,
                                "grad_diff_of_max": dgs}})

    series, iter_secs, iter_fg = [], [], []

    def record(wrk, iteration):
        series.append(float(wrk.result.J_T))
        iter_secs.append(float(wrk.result.secs))
        iter_fg.append(int(wrk.fg_count[0]))

    t0 = time.perf_counter()
    res = gt.optimize(
        trajs, tlist, gradient_method="taylor", iter_stop=ITER_STOP,
        print_iters=False, rethrow_exceptions=True, callback=record, **kw,
    )
    torch.cuda.synchronize()
    opt_s = time.perf_counter() - t0
    counts = read_counts(hopper_prop, hopper_frechet, hopper_cheby)
    routes_q = ROUTE_READS[-1][1]
    n_fg += res.fg_calls
    n_f += res.f_calls
    require(len(series) == ITER_STOP + 1 and res.iter == ITER_STOP,
            f"optimize_smalld: {res.message}, series {series}")
    require(routes_q["smalld_fused"] == n_fg + n_f
            and routes_q["smalld_pair"] == 0,
            f"the qutrits' forward passes took {routes_q}")
    k7["launches_fused_qutrit_run"] = routes_q["smalld_fused"]
    require(all(math.isfinite(v) for v in series)
            and all(b < a for a, b in zip(series, series[1:])),
            f"qutrit J_T does not fall monotonically: {series}")
    expect = dict.fromkeys(counts, 0)
    expect.update({"forward_scan_smalld": n_fg + n_f,
                   "chi_scan_grouped": n_fg})
    require(counts == expect, f"qutrit launch counts {counts} do not match "
            f"the evaluations {expect}")
    steady_s = sum(iter_secs[1:])
    emit({"phase": "optimize_smalld", "J_T_series": series,
          "iterations": res.iter, "seconds": opt_s,
          "iters_per_second": res.iter / opt_s,
          "iteration_seconds": iter_secs, "iteration_fg_calls": iter_fg,
          "steady_ms_per_fg": steady_s / max(sum(iter_fg[1:]), 1) * 1e3,
          "steady_iters_per_second": ITER_STOP / steady_s,
          "fg_calls": res.fg_calls, "f_calls": res.f_calls,
          "message": res.message, "launches": counts,
          "route_launches": {k: routes_q[k]
                             for k in ("smalld_fused", "smalld_pair")}})

    # ---- the CZ gate with the taylor gradient -----------------------------
    cp_t = gt.compile_problem(
        cz_problem.trajectories, cz_problem.tlist, dtype=np.complex64,
        gradient_method="taylor", **cz_problem.kwargs,
    )
    orders_cz = _vectorized_taylor_orders(cp_t)
    require(orders_cz is not None and _reuse_U_enabled(cp_t),
            "the CZ gate must take the vectorized Taylor pass over stored "
            "propagators")
    x_cz = cp_t.guess_pulsevals.reshape(-1)
    zero_counts(hopper_prop, hopper_frechet, hopper_cheby)
    fg_t = gt.build_fg(cp_t)
    J_t, g_t, aux_t, dJ_t, dg_t = fg_against_plain(fg_t, x_cz, "fg_taylor_cz")
    require(bool(aux_t["taylor_ok"]), "CZ: the Taylor series did not converge")
    d_tg = max_abs(g_t, g_cz_gradgen) / float(g_cz_gradgen.abs().max())
    require(d_tg < 2e-3, "CZ: taylor and gradgen gradients differ by "
            f"{d_tg} of the max")
    taylor_ms = timed_ms(lambda: fg_t(x_cz), 3)
    parts_cz = fg_breakdown(fg_t, x_cz)
    counts_cz = read_counts(hopper_prop, hopper_frechet, hopper_cheby)
    expect = dict.fromkeys(counts_cz, 0)
    expect.update({"forward_scan_shared": 8, "chi_scan_shared": 8})
    require(counts_cz == expect, f"CZ-taylor launch counts {counts_cz} do "
            f"not match the evaluations {expect}")
    emit({"phase": "fg_taylor_cz", "J": float(J_t),
          "taylor_ms_per_eval": taylor_ms, "gradgen_ms_per_eval": cz_fg_ms,
          "taylor_flop_rate": flop_rate(cp_t, taylor_ms),
          "device_ms_by_part": parts_cz, "taylor_orders": orders_cz,
          "taylor_ok": bool(aux_t["taylor_ok"]),
          "J_abs_diff_vs_plain": dJ_t, "grad_diff_of_max_vs_plain": dg_t,
          "grad_diff_of_max_vs_gradgen": d_tg, "launches": counts_cz})

    # ---- the per-step backward pass, at a small size ----------------------
    # eight qutrits, 50 steps: the vectorized Taylor pass in complex128 is
    # the yardstick; the per-step passes (taylor with and without stored
    # propagators, gradgen) in both precisions are held against it
    small = transmon_ensemble_trajectories(8, d=3, T=2.5, seed=SEED)
    tl_s = np.linspace(0, 2.5, 51)

    step_calls = {"taylor_grad_step": 0, "gradgen_step": 0}

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            step_calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    def grad(dtype, **options):
        """J and gradient of the small problem; the per-step functions are
        counted, so that a pass that did not go step by step shows."""
        cp_s = gt.compile_problem(small, tl_s, J_T=J_T_sm, dtype=dtype,
                                  **options)
        originals = {name: getattr(F, name) for name in step_calls}
        for name, fn in originals.items():
            step_calls[name] = 0
            setattr(F, name, counting(name, fn))
        try:
            J_s, g_s, aux_s = gt.build_fg(cp_s)(
                cp_s.guess_pulsevals.reshape(-1))
        finally:
            for name, fn in originals.items():
                setattr(F, name, fn)
        per_step = not options.get("vectorize_backward", True)
        method = options["gradient_method"]
        expect = dict.fromkeys(step_calls, 0)
        if per_step:
            expect[f"{method}_step" if method == "gradgen"
                   else "taylor_grad_step"] = cp_s.n_timesteps
        require(step_calls == expect, f"per-step fallback {options}: step "
                f"functions called {step_calls}, expected {expect}")
        require(bool(aux_s["taylor_ok"]) and bool(torch.isfinite(g_s).all()),
                f"per-step fallback {options}: not converged or not finite")
        return float(J_s), g_s.double()

    J_ref, g_ref = grad(np.complex128, gradient_method="taylor")
    variants = {
        "taylor": dict(gradient_method="taylor", vectorize_backward=False),
        "taylor_no_reuse": dict(gradient_method="taylor",
                                vectorize_backward=False,
                                reuse_propagators=False),
        "gradgen": dict(gradient_method="gradgen", vectorize_backward=False),
    }
    worst = {}
    t0 = time.perf_counter()
    for dtype, tol_J, tol_g in ((np.complex128, 1e-12, 1e-9),
                                (np.complex64, 1e-5, 2e-3)):
        for name, options in variants.items():
            J_s, g_s = grad(dtype, **options)
            dJ_s = abs(J_s - J_ref)
            dg_s = float((g_s - g_ref).abs().max() / g_ref.abs().max())
            worst[f"{name}_{np.dtype(dtype).name}"] = {
                "J_abs_diff": dJ_s, "grad_diff_of_max": dg_s}
            require(dJ_s < tol_J and dg_s < tol_g, "per-step fallback "
                    f"{name} in {np.dtype(dtype).name}: dJ {dJ_s}, dgrad "
                    f"{dg_s} against the vectorized pass")
    emit({"phase": "per_step_fallback",
          "shape": {"d": 3, "K": 8, "N_T": 50},
          "tolerances": {"complex128": [1e-12, 1e-9],
                         "complex64": [1e-5, 2e-3]},
          "against_vectorized_taylor_complex128": worst,
          "step_function_calls_per_evaluation": 50,
          "seconds": time.perf_counter() - t0})
    return k7, counts, counts_cz, counts_gg


def prop_routes_phase(cp, cp_ens, s_main, dev):
    """Phase ``prop_routes``: the propagator kernel on its two routes, each
    forced, on the same inputs (the guess pulse plus seeded noise) at the
    propagator shapes of K1 (the CZ's one generator, 2000 steps), K4 (the
    ensemble's 8 groups), K5 (one generator per trajectory, 32 of them) at
    s = 0..3 and K10 (4 generators) at the main paths' s, each against its
    plain version (< TOL_STATE) and, at the main paths' s, against
    ``torch.linalg.matrix_exp`` on the same exponentials (K5: four calls of
    16000 matrices summed).  Returns the kernel line's numbers of the
    cluster kernel (K1 at the main path's s)."""
    from grape_tpu_torch.ops import hopper_prop as hp

    rng = np.random.default_rng(SEED + 7)
    c64 = lambda x: torch.tensor(x, dtype=torch.complex64, device=dev)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    d, N_T = cp.dim, cp.n_timesteps
    require(hp.propagator_route(d) == "cluster",
            f"d = {d} must take the cluster propagator kernel")

    def table(c):
        eps = c.guess_pulsevals + 0.02 * rng.normal(size=(c.n_controls, N_T))
        return f32(np.einsum("ntl,ln->nt", c.M, eps) + c.Mfix)

    dts = f32(np.diff(cp.tlist))
    gs = cp_ens.n_traj // cp_ens.H0.shape[0]
    H0g, opsg = c64(cp_ens.H0), c64(cp_ens.ops)
    co_e = table(cp_ens)
    shapes = {
        "K1": (c64(cp.H0[:1]), c64(cp.ops[:1]), table(cp)),
        "K4": (H0g, opsg, co_e),
        "K5": (H0g.repeat_interleave(gs, dim=0).contiguous(),
               opsg.repeat_interleave(gs, dim=0).contiguous(), co_e),
        "K10": (H0g[:4].contiguous(), opsg[:4].contiguous(), co_e),
    }
    rows = []
    k1 = {}
    for name, (H0, ops, co) in shapes.items():
        G = H0.shape[0]
        items = N_T * G
        reps = 2 if items > 20000 else 3
        for s in (range(4) if name != "K10" else [s_main]):
            U = {}
            ms = {}
            for route in ("cluster", "global"):
                with hp._forced_routes(propagators=route):
                    fn = (lambda: hp.propagators(H0, ops, co, dts, s))
                    U[route] = fn()
                    ms[route] = median_ms(fn, reps=reps)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            U_p = hp._propagators_plain(H0, ops, co, dts, s)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            err = {r: max_abs(u, U_p) for r, u in U.items()}
            require(finite(U["cluster"]) and max(err.values()) < TOL_STATE,
                    f"propagators of {name} at s={s} disagree with their "
                    f"plain version: {err}")
            flops = items * (6 + s) * 8.0 * d ** 3
            byts = nbytes(H0, ops, co, dts, U["cluster"])
            b_ms, b_by = bound(flops, byts)
            row = {"shape": name, "G": G, "N_T": N_T, "items": items, "s": s,
                   "cluster_ms": ms["cluster"], "global_ms": ms["global"],
                   "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "cluster_of_bound": b_ms / ms["cluster"],
                   "err_cluster": err["cluster"], "err_global": err["global"]}
            del U, U_p
            if s == s_main:
                # the library call on the same exponentials (no squarings:
                # it scales by itself); one call on 64000 matrices faults
                # (see ensemble_kernel_phases), so at most 16000 a call
                a_c = (-1j * dts.to(torch.complex64))[:, None, None, None]
                co_c = co.to(torch.complex64)
                total = 0.0
                n_parts = max(1, items // 16000)
                for steps in torch.arange(N_T, device=dev).chunk(n_parts):
                    A = (a_c[steps] * (H0[None] + torch.einsum(
                        "nt,gtij->ngij", co_c[steps], ops))).reshape(-1, d, d)
                    total += median_ms(lambda: torch.linalg.matrix_exp(A),
                                       reps=reps)
                    del A
                    torch.cuda.empty_cache()
                row["library_ms"] = total
                row["library_calls"] = n_parts
            torch.cuda.empty_cache()
            rows.append(row)
            if name == "K1" and s == s_main:
                k1 = {"ms": row["cluster_ms"], "plain_ms": plain_ms,
                      "flops": flops, "bytes": byts,
                      "library_ms": row["library_ms"],
                      "library_call": "torch.linalg.matrix_exp on (N_T, d, "
                                      "d): the same exponentials",
                      "err": err["cluster"],
                      "global_route_ms": row["global_ms"]}
    for r in rows:
        require(r["cluster_ms"] < r["global_ms"], "the cluster propagator "
                f"kernel is slower than the global one at {r}")
    wide_rows, k_wide = wide_route_rows(dev)
    emit({"phase": "prop_routes", "tol": TOL_STATE,
          "resident_clusters": hp.load_kernels()
          .grape_propagators_cluster_resident(d), "rows": rows,
          "wide_rows": wide_rows})
    for r in wide_rows:
        require(r["wide_ms"] < r["global_ms"], "the wide propagator kernel "
                f"is slower than the global one at {r}")
        require(r["d"] < 256 or r["wide_ms"] <= r["plain_ms"],
                f"the wide propagator kernel is slower than plain at {r}")
    zero_counts(hp)
    return k1, k_wide


# the wide propagator kernel's shapes: (d, N_T), one seeded generator, and
# the items each route is also held against complex128 on
WIDE_ROUTE_SHAPES = ((128, 2000), (256, 2000), (512, 400), (1024, 100))
WIDE_C128_ITEMS = 8


def wide_route_rows(dev):
    """The wide propagator kernel (the rule's route past d = 108) against
    the global-scratch kernel forced, the plain version and
    ``torch.linalg.matrix_exp`` on the same exponentials, at the
    ``WIDE_ROUTE_SHAPES`` (seeded Hermitian generators of the spread of
    ``random_group_inputs``, one group, T = 4), each at s = 0 and at the
    squaring count the 1-norm rule gives these generators (``expm``'s,
    theta = 2); the bound both ways: 6 d^3 operations a product (the
    Karatsuba form the kernel computes) and 8 d^3 (four real products).
    Each kernel within ``TOL_STATE`` of plain.  Returns ``(rows, the kernel
    line's numbers at d = 1024 and its s)``."""
    from grape_tpu_torch.ops import hopper_prop as hp
    from grape_tpu_torch.ops.expm import _norm_squarings

    c128 = lambda x: x.to(torch.complex128 if x.is_complex()
                          else torch.float64)
    rng = np.random.default_rng(SEED + 11)
    rows, k_wide = [], {}
    for d, N_T in WIDE_ROUTE_SHAPES:
        H0, ops, co, dts, _, _ = random_group_inputs(rng, dev, d, 1, 1, 4,
                                                     N_T, 10.0, False)
        A = ((-1j * dts.to(torch.complex64))[:, None, None] * (
            H0 + torch.einsum("nt,tij->nij", co.to(torch.complex64), ops[0])))
        s_path = _norm_squarings(A, 2.0, 32)
        reps = 3 if N_T * d ** 3 < 4e11 else 2
        for s in sorted({0, s_path}):
            U, ms = {}, {}
            for route in ("wide", "global"):
                with hp._forced_routes(propagators=route):
                    fn = (lambda: hp.propagators(H0, ops, co, dts, s))
                    U[route] = fn()
                    ms[route] = median_ms(fn, reps=reps)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            U_p = hp._propagators_plain(H0, ops, co, dts, s)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            err = {r: max_abs(u, U_p) for r, u in U.items()}
            require(finite(U["wide"]) and max(err.values()) < TOL_STATE,
                    f"propagators at d={d}, s={s} disagree with their plain "
                    f"version: {err}")
            # each route's distance from complex128 on the first items
            n_x = WIDE_C128_ITEMS
            U_x = hp._propagators_plain(c128(H0), c128(ops), c128(co[:n_x]),
                                        c128(dts[:n_x]), s)
            err_x = {r: max_abs(u[:n_x].to(torch.complex128), U_x)
                     for r, u in (("wide", U["wide"]), ("global", U["global"]),
                                  ("plain", U_p))}
            del U_x
            products = N_T * (6 + s)
            byts = nbytes(H0, ops, co, dts, U["wide"])
            b6, b6_by = bound(products * 6.0 * d ** 3, byts)
            b8, b8_by = bound(products * 8.0 * d ** 3, byts)
            plan = hp.wide_plan(d, N_T)
            row = {"d": d, "N_T": N_T, "s": s, "s_path": s_path,
                   "plan": {k: plan[k] for k in ("tile", "tiles", "window",
                                                 "windows")},
                   "wide_ms": ms["wide"], "global_ms": ms["global"],
                   "plain_ms": plain_ms,
                   "bound_ms_6d3": b6, "bound_by_6d3": b6_by,
                   "bound_ms_8d3": b8, "bound_by_8d3": b8_by,
                   "wide_of_bound_6d3": b6 / ms["wide"],
                   "wide_tflops_6d3": products * 6.0 * d ** 3
                   / (ms["wide"] * 1e-3) / 1e12,
                   "err_wide": err["wide"], "err_global": err["global"],
                   "err_vs_complex128_first_items": err_x}
            del U, U_p
            torch.cuda.empty_cache()
            if s == s_path:
                row["library_ms"] = median_ms(
                    lambda: torch.linalg.matrix_exp(A), reps=reps)
                row["library_call"] = ("torch.linalg.matrix_exp on the same "
                                       "(N_T, d, d) matrices")
            rows.append(row)
            if d == 1024 and s == s_path:
                k_wide = {"ms": ms["wide"], "plain_ms": plain_ms,
                          "library_ms": row["library_ms"],
                          "library_call": row["library_call"],
                          "flops": products * 6.0 * d ** 3, "bytes": byts,
                          "bound_ms_8d3": b8, "err": err["wide"],
                          "global_route_ms": ms["global"], "d": d,
                          "N_T": N_T, "squarings": s}
        del A
        torch.cuda.empty_cache()
    return rows, k_wide


def scan_routes_phase(dev):
    """Phase ``scan_routes``: the state scans on their two routes, each
    forced, on the same propagators (the kernel's, of seeded random
    generators at d = 100 over 2000 steps) and states: one group of 4 (the
    CZ), 8 groups of 4 and 32 groups of 1 (the ensembles), both directions,
    against the plain chains (< TOL_STATE), with the time per step; beside
    the rule's cluster size the neighbouring ones, timed forward.  Returns
    the kernel line's numbers of the cluster scan (the CZ's shape)."""
    from grape_tpu_torch.ops import _build
    from grape_tpu_torch.ops import hopper_prop as hp

    rng = np.random.default_rng(SEED + 8)
    lib = _build.load_kernels()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    d, N_T = 100, 2000
    rows = []
    cz = {}
    for (G, gs, sizes) in [(1, 4, (16, 8, 4)), (8, 4, (16, 8, 4)),
                           (32, 1, (4, 2, 1))]:
        K = G * gs
        Hs, Os, cs, ts, p0, x0 = random_group_inputs(
            rng, dev, d, G, gs, 4, N_T, 10.0, False)
        U = hp.propagators(Hs, Os, cs, ts, 0)
        st = torch.empty((N_T + 1, K, d), dtype=torch.complex64, device=dev)
        chis = torch.empty((N_T, K, d), dtype=torch.complex64, device=dev)
        carry = torch.empty_like(x0)
        # the plain chains on the same propagators
        Ut = U.transpose(-1, -2)
        psi = p0.reshape(G, gs, d)
        st_p = [p0]
        for n in range(N_T):
            psi = psi @ Ut[n]
            st_p.append(psi.reshape(K, d))
        st_p = torch.stack(st_p)
        chis_p = torch.empty_like(chis)
        carry_p = hp.chi_window_plain(U, x0, chis_p)
        plan = hp.scan_route(d, G, gs, sms)
        row = {"G": G, "gs": gs, "d": d, "N_T": N_T, "plan": plan}
        for route in ("cluster", "legacy"):
            with hp._forced_routes(scan=None if route == "cluster"
                                   else "legacy"):
                fwd = lambda: hp._state_scan(lib, U, p0, st, None, False)
                chi = lambda: hp._state_scan(lib, U, x0, chis, carry, True)
                fwd()
                chi()
                torch.cuda.synchronize()
                e = max(max_abs(st, st_p), max_abs(chis, chis_p),
                        max_abs(carry, carry_p))
                require(finite(st, chis, carry) and e < TOL_STATE,
                        f"the {route} state scans disagree with the plain "
                        f"chains at G={G}, gs={gs}: {e}")
                row[f"{route}_err"] = e
                row[f"{route}_forward_ms"] = median_ms(fwd, reps=3)
                row[f"{route}_chi_ms"] = median_ms(chi, reps=3)
                row[f"{route}_forward_us_per_step"] = (
                    row[f"{route}_forward_ms"] * 1e3 / N_T)
                row[f"{route}_chi_us_per_step"] = (
                    row[f"{route}_chi_ms"] * 1e3 / N_T)
        row["forward_ms_by_cluster"] = {}
        for c in sizes:
            with hp._forced_routes(scan=c):
                row["forward_ms_by_cluster"][c] = median_ms(
                    lambda: hp._state_scan(lib, U, p0, st, None, False),
                    reps=3)
            row.setdefault("resident_clusters", {})[c] = (
                lib.grape_state_scan_resident(
                    0, d, G, gs, plan["kb"], c,
                    hp.scan_route(d, G, gs, sms, cluster=c)["stages"]))
        for direction in ("forward", "chi"):
            require(row[f"cluster_{direction}_ms"]
                    <= row[f"legacy_{direction}_ms"],
                    f"the cluster scan ({direction}) is slower than the "
                    f"one-block scan at G={G}, gs={gs}: {row}")
        if G == 1:
            require(2 * row["cluster_forward_ms"] <= row["legacy_forward_ms"]
                    and 2 * row["cluster_chi_ms"] <= row["legacy_chi_ms"],
                    f"at the CZ's shape the cluster scan is not twice as "
                    f"fast as the one-block scan: {row}")
            cz = {"ms": row["cluster_forward_ms"],
                  "ms_chi": row["cluster_chi_ms"],
                  "us_per_step": row["cluster_forward_us_per_step"],
                  "us_per_step_chi": row["cluster_chi_us_per_step"],
                  "legacy_ms": row["legacy_forward_ms"],
                  "legacy_ms_chi": row["legacy_chi_ms"],
                  "err": row["cluster_err"],
                  "flops": N_T * 8.0 * K * d * d,
                  "bytes": nbytes(U, p0, st)}
            # the plain forward chain alone (the propagators given)
            t0 = time.perf_counter()
            psi = p0
            for n in range(N_T):
                psi = psi @ Ut[n, 0]
            torch.cuda.synchronize()
            cz["plain_ms"] = (time.perf_counter() - t0) * 1e3
        rows.append(row)
        del U, Ut, st, chis, st_p, chis_p
        torch.cuda.empty_cache()
    grid_rows, k_grid = grid_scan_rows(dev, lib, sms)
    grid_checks = grid_scan_shapes(dev, lib, sms)
    emit({"phase": "scan_routes", "tol": TOL_STATE, "sm_count": sms,
          "rows": rows, "grid_rows": grid_rows,
          "grid_shapes": {"tol": TOL_TRJ, "checks": grid_checks}})
    for row in grid_rows:
        for direction in ("forward", "chi"):
            require(row[f"grid_{direction}_ms"]
                    < row[f"legacy_{direction}_ms"],
                    f"the grid scan ({direction}) is slower than the "
                    f"one-block scan at {row}")
            if row["d"] == 1024 and row["K"] == 2:
                require(row[f"grid_{direction}_ms"] <= GRID_SCAN_LIMIT_MS,
                        f"the grid scan ({direction}) takes more than "
                        f"{GRID_SCAN_LIMIT_MS} ms at dim 1024, K = 2: {row}")
    zero_counts(hp)
    return cz, k_grid


# the grid scan's layouts past the paths' shapes: (d, G, gs, N_T) -- odd d
# (element copies, not TMA), a partial second piece, several chunks with
# three pieces of 8 entries a CTA, more chunks than SMs (rounds), d < 256
GRID_SCAN_LAYOUTS = ((419, 1, 1, 20), (450, 1, 4, 12), (450, 3, 5, 12),
                     (300, 140, 1, 3), (130, 1, 4, 9))


def grid_scan_shapes(dev, lib, sms):
    """The grid scan forced at ``GRID_SCAN_LAYOUTS``, both directions (the
    co-state with and without the carry), against the plain chains on the
    same propagators (< TOL_TRJ), with each shape's plan."""
    from grape_tpu_torch.ops import hopper_prop as hp

    rng = np.random.default_rng(SEED + 13)
    checks = []
    for d, G, gs, N_T in GRID_SCAN_LAYOUTS:
        K = G * gs
        Hs, Os, cs, ts, p0, x0 = random_group_inputs(rng, dev, d, G, gs, 2,
                                                     N_T, 10.0, False)
        U = hp.propagators(Hs, Os, cs, ts, 0)
        psi, st_p = p0.reshape(G, gs, d), [p0]
        for n in range(N_T):
            psi = psi @ U[n].transpose(-1, -2)
            st_p.append(psi.reshape(K, d))
        st_p = torch.stack(st_p)
        chis_p = torch.empty((N_T, K, d), dtype=torch.complex64, device=dev)
        carry_p = hp.chi_window_plain(U, x0, chis_p)
        st = torch.empty_like(st_p)
        chis, chis_nc = torch.empty_like(chis_p), torch.empty_like(chis_p)
        carry = torch.empty_like(x0)
        with hp._forced_routes(scan="grid"):
            hp._state_scan(lib, U, p0, st, None, False)
            hp._state_scan(lib, U, x0, chis, carry, True)
            hp._state_scan(lib, U, x0, chis_nc, None, True)
        torch.cuda.synchronize()
        e = max(max_abs(st, st_p), max_abs(chis, chis_p),
                max_abs(carry, carry_p), max_abs(chis_nc, chis_p))
        plan = hp.scan_route(d, G, gs, sms, cluster="grid")
        checks.append({"d": d, "G": G, "gs": gs, "N_T": N_T,
                       "plan": {k: plan[k] for k in (
                           "kb", "teams", "ctas", "entries", "groups",
                           "stages")}, "max_abs_err": e})
        require(finite(st, chis, carry) and e < TOL_TRJ,
                f"the grid scan disagrees with the plain chains at "
                f"{checks[-1]}")
        del U, st, st_p, chis, chis_p, chis_nc
    zero_counts(hp)
    return checks


# the grid scan's shapes: (d, N_T) at one group of K = 2 and 4, and its
# limit at dim 1024, N_T = 100, K = 2 (each direction)
GRID_SCAN_SHAPES = ((512, 400), (1024, 100))
GRID_SCAN_LIMIT_MS = 2.0


def grid_scan_rows(dev, lib, sms):
    """The grid state scan (the rule's route past the cluster scan) against
    the one-block scans forced (past d = 807 the χ chain as the forward
    scan over the reversed adjoint copy) and the plain chains, on the same
    propagators (the wide kernel's, of seeded generators) and states, at
    ``GRID_SCAN_SHAPES`` with K = 2 and 4 in one group, both directions
    (< TOL_STATE).  Returns ``(rows, the kernel line's numbers at dim 1024,
    K = 2)``."""
    from grape_tpu_torch.ops import hopper_prop as hp

    rng = np.random.default_rng(SEED + 12)
    rows, k_grid = [], {}
    for d, N_T in GRID_SCAN_SHAPES:
        Hs, Os, cs, ts, _, _ = random_group_inputs(rng, dev, d, 1, 1, 4,
                                                   N_T, 10.0, False)
        U = hp.propagators(Hs, Os, cs, ts, 0)
        Ut = U.transpose(-1, -2)
        for K in (2, 4):
            _, _, _, _, p0, x0 = random_group_inputs(rng, dev, d, 1, K, 1, 1,
                                                     1.0, False)
            st = torch.empty((N_T + 1, K, d), dtype=torch.complex64,
                             device=dev)
            chis = torch.empty((N_T, K, d), dtype=torch.complex64,
                               device=dev)
            carry = torch.empty_like(x0)
            psi, st_p = p0, [p0]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for n in range(N_T):
                psi = psi @ Ut[n, 0]
                st_p.append(psi)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            st_p = torch.stack(st_p)
            chis_p = torch.empty_like(chis)
            carry_p = hp.chi_window_plain(U, x0, chis_p)
            plan = hp.scan_route(d, 1, K, sms)
            require(plan["route"] == "grid",
                    f"d = {d}, K = {K} must take the grid scan: {plan}")
            row = {"d": d, "K": K, "N_T": N_T, "plan": plan,
                   "plain_forward_ms": plain_ms}
            for route in ("grid", "legacy"):
                with hp._forced_routes(scan=None if route == "grid"
                                       else "legacy"):
                    zero_counts(hp)
                    fwd = lambda: hp._state_scan(lib, U, p0, st, None, False)
                    chi = lambda: hp._state_scan(lib, U, x0, chis, carry,
                                                 True)
                    fwd()
                    chi()
                    torch.cuda.synchronize()
                    row[f"{route}_routes"] = {
                        k: v for k, v in hp.route_launches.items() if v}
                    e = max(max_abs(st, st_p), max_abs(chis, chis_p),
                            max_abs(carry, carry_p))
                    require(finite(st, chis, carry) and e < TOL_STATE,
                            f"the {route} state scans disagree with the "
                            f"plain chains at d={d}, K={K}: {e}")
                    row[f"{route}_err"] = e
                    row[f"{route}_forward_ms"] = median_ms(fwd, reps=3)
                    row[f"{route}_chi_ms"] = median_ms(chi, reps=3)
            for direction in ("forward", "chi"):
                row[f"grid_{direction}_us_per_step"] = (
                    row[f"grid_{direction}_ms"] * 1e3 / N_T)
            require(row["grid_routes"] == {"state_scan_grid_forward": 1,
                                           "state_scan_grid_chi": 1},
                    f"the rule's scans at d={d}, K={K} took "
                    f"{row['grid_routes']}")
            b_ms, b_by = bound(N_T * 8.0 * K * d * d, nbytes(U, p0, st))
            row.update(bound_ms=b_ms, bound_by=b_by)
            rows.append(row)
            if d == 1024 and K == 2:
                k_grid = {"ms": row["grid_forward_ms"],
                          "ms_chi": row["grid_chi_ms"],
                          "us_per_step": row["grid_forward_us_per_step"],
                          "us_per_step_chi": row["grid_chi_us_per_step"],
                          "legacy_ms": row["legacy_forward_ms"],
                          "legacy_ms_chi": row["legacy_chi_ms"],
                          "plain_ms": plain_ms, "err": row["grid_err"],
                          "flops": N_T * 8.0 * K * d * d,
                          "bytes": nbytes(U, p0, st), "d": d, "K": K,
                          "N_T": N_T}
            del st, chis, st_p, chis_p
        del U, Ut
        torch.cuda.empty_cache()
    return rows, k_grid


def cluster_shapes_phase(dev):
    """Phase ``kernel_shapes_cluster``: the forward scans and co-state
    chains against their plain versions where the two redesigned kernels
    change layout: d = 37 (odd: element copies into the scan's ring, not
    TMA), 100 (the paths' own) and 129 (past the cluster propagator kernel:
    the wide kernel), for one group of 4, 8 groups of 4 and 32 groups of
    1, at s = 0..3, 40 steps (windows of 7 steps for the versions that keep
    no U stream), to < TOL_TRJ; with the routes each shape took."""
    from grape_tpu_torch.ops import hopper_prop as hp
    from grape_tpu_torch.ops import plain_versions

    rng = np.random.default_rng(SEED + 9)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    checks = []
    window_bytes = hp._WINDOW_BYTES
    for d in (37, 100, 129):
        for (G, gs) in ((1, 4), (8, 4), (32, 1)):
            for s in range(4):
                N_ = 40
                Hs, Os, cs, ts, p0, x0 = random_group_inputs(
                    rng, dev, d, G, gs, 2, N_, 10.0 * 2 ** s, s % 2 == 1)

                def run():
                    out = hp.forward_scan_grouped(Hs, Os, cs, ts, p0, gs, s)
                    chis = hp.chi_scan_grouped(out[1], x0)
                    hp._WINDOW_BYTES = 7 * G * d * d * 8
                    try:
                        st_w, _ = hp.forward_scan_grouped(
                            Hs, Os, cs, ts, p0, gs, s, with_propagators=False)
                        chis_r, carry = hp.chi_scan_recompute(
                            Hs, Os, cs, ts, x0, s)
                    finally:
                        hp._WINDOW_BYTES = window_bytes
                    return out[0], out[1], chis, st_w, chis_r, carry

                zero_counts(hp)
                got = run()
                torch.cuda.synchronize()
                routes = {k: v for k, v in hp.route_launches.items() if v}
                with plain_versions():
                    want = run()
                e = max(max_abs(a, b) for a, b in zip(got, want))
                checks.append({"d": d, "G": G, "gs": gs, "s": s, "N_T": N_,
                               "propagator_route": hp.propagator_route(d),
                               "scan_plan": hp.scan_route(d, G, gs, sms),
                               "route_launches": routes,
                               "max_abs_err": e})
                require(finite(*got) and e < TOL_TRJ, "the redesigned "
                        f"kernels disagree at {checks[-1]}")
    require(any(c["propagator_route"] == "wide" for c in checks)
            and {2, 8, 16} <= {c["scan_plan"]["cluster"] for c in checks},
            "the shapes must reach both propagator routes and the cluster "
            "sizes 2, 8 and 16")
    emit({"phase": "kernel_shapes_cluster", "tol": TOL_TRJ,
          "checks": checks})
    zero_counts(hp)


def phase_clock_phase(dev):
    """Phase ``cluster_phase_clock``: where the time of the two cluster
    kernels, the Chebyshev ring kernel and the factored Frechet kernel
    goes, from their phase clocks (a second build of their sources with
    ``-DGRAPE_PHASE_CLOCK``; block 0's SM cycles per phase, per item, step
    or term, a phase that ends at a wait including the wait): the
    propagator kernel at K1's shape (one
    generator, 2000 steps) at s = 0 and 2, the state scan at the CZ's shape
    both ways and at 8 x 4 and 32 x 1 forward, the ring kernel forward at
    dim 1024 (K = 4 and 64) and dim 256 (K = 4), the factored Frechet
    kernel at K3's (1 x 4) and K6's (8 x 4) shapes at s = 0 and 1, with the
    SM clock read under load."""
    import ctypes

    from grape_tpu_torch.ops import _build
    from grape_tpu_torch.ops import hopper_prop as hp

    t0 = time.perf_counter()
    lib = _build.load_phase_clock()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 10)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    table = ctypes.c_ulonglong * 16
    reps = 3

    def run(launch, read):
        buf = table()
        check = lambda rc: require(rc == 0, f"clocked launch: error {rc}")
        check(launch())
        torch.cuda.synchronize()
        check(read(buf))
        for _ in range(reps):
            check(launch())
        torch.cuda.synchronize()
        check(read(buf))
        return list(buf)

    d, N_T = 100, 2000
    prop_names = {0: "A_and_its_exchange", 1: "A2_A3_A4", 2:
                  "A4_exchange_and_E", 4: "horner", 5: "squarings"}
    props = []
    H1, O1, c1, t1, _, _ = random_group_inputs(rng, dev, d, 1, 4, 4, N_T,
                                               10.0, False)
    U = torch.empty((N_T, 1, d, d), dtype=torch.complex64, device=dev)

    def launch_k1(s):
        return lib.grape_propagators_cluster(
            H1.data_ptr(), O1.data_ptr(), c1.data_ptr(), t1.data_ptr(), 4, d,
            N_T, 1, 0, s, U.data_ptr(), stream)

    resident = lib.grape_propagators_cluster_resident(d)
    per_block = -(-N_T // min(N_T, resident))
    for s in (0, 2):
        t = run(lambda: launch_k1(s), lib.grape_propagators_cluster_clock)
        props.append({"s": s, "items_of_block_0": per_block,
                      "cycles_per_item": {name: t[i] / (reps * per_block)
                                          for i, name in prop_names.items()}})
    scan_names = {0: "waits", 3: "products_and_reduction", 4: "pushes",
                  1: "emission_and_slot_release"}
    scans = []
    for (G, gs, chi) in [(1, 4, 0), (1, 4, 1), (8, 4, 0), (32, 1, 0)]:
        Hs, Os, cs, ts, p0, x0 = random_group_inputs(
            rng, dev, d, G, gs, 4, N_T, 10.0, False)
        Ug = hp.propagators(Hs, Os, cs, ts, 0)
        out = torch.empty((N_T + 1, G * gs, d), dtype=torch.complex64,
                          device=dev)
        plan = hp.scan_route(d, G, gs, sms)
        t = run(lambda: lib.grape_state_scan(
            Ug.data_ptr(), (x0 if chi else p0).data_ptr(), out.data_ptr(),
            None, chi, N_T, G * gs, d, G, gs, plan["kb"], plan["cluster"],
            plan["stages"], stream), lib.grape_state_scan_clock)
        steps = reps * (N_T - chi)
        scans.append({"G": G, "gs": gs, "direction": "chi" if chi else
                      "forward", "plan": plan,
                      "cycles_per_step": {name: t[i] / steps
                                          for i, name in scan_names.items()}})
        del Ug, out
    # the Chebyshev ring kernel: compute warp 0 (it also owns the slab) per
    # term, the row-forming warp per step
    from grape_tpu_torch.ops import hopper_cheby as hc

    ring_names = {5: "step_start_and_loop", 0: "flag_waits",
                  1: "loads_and_fmas", 2: "fold_across_lanes_and_warps",
                  3: "update_publish_release"}
    rings = []
    for (d_c, K_c, N_c, nc) in [(1024, 4, 100, 27), (1024, 64, 100, 27),
                                (256, 4, 200, 22)]:
        A = rng.normal(size=(d_c, d_c)) + 1j * rng.normal(size=(d_c, d_c))
        c64 = lambda x: torch.tensor(np.ascontiguousarray(x),
                                     dtype=torch.complex64, device=dev)
        planes = c64(np.broadcast_to(0.5 * (A + A.conj().T) / np.sqrt(d_c),
                                     (3, d_c, d_c)))
        co = torch.tensor(0.3 * rng.normal(size=(N_c, 2)),
                          dtype=torch.float32, device=dev)
        tab = c64(0.2 * (rng.normal(size=(N_c, nc))
                         + 1j * rng.normal(size=(N_c, nc))))
        ph = c64(np.exp(0.3j * rng.uniform(size=N_c)))
        psi = c64(rng.normal(size=(K_c, d_c)) / np.sqrt(2 * d_c))
        plan = hc.cheby_route(d_c, K_c, sms)
        ring = torch.empty((2, K_c, d_c), dtype=torch.complex64, device=dev)
        flags = torch.zeros(plan["blocks"] * plan["wk"] * hc.RING_FLAG_STRIDE,
                            dtype=torch.int32, device=dev)
        out_c = torch.empty((N_c, K_c, d_c), dtype=torch.complex64,
                            device=dev)

        def launch_ring():
            flags.zero_()
            return lib.grape_cheby_ring(
                planes.data_ptr(), co.data_ptr(), tab.data_ptr(),
                ph.data_ptr(), 0.1, 0.2, psi.data_ptr(), 2, d_c, K_c, N_c,
                nc, 0, plan["rows"], plan["tr"], plan["tk"], plan["wk"],
                plan["chunks"], plan["smem"], ring.data_ptr(),
                flags.data_ptr(), out_c.data_ptr(), stream)

        t = run(launch_ring, lib.grape_cheby_ring_clock)
        terms = reps * N_c * (nc - 1) * plan["chunks"]
        per_term = {name: t[i] / terms for i, name in ring_names.items()}
        rings.append({
            "d": d_c, "K": K_c, "N_T": N_c, "n_cheby": nc, "plan": plan,
            "cycles_per_term_and_chunk": per_term,
            "cycles_per_term_total": sum(per_term.values()),
            "row_forming_cycles_per_step": t[6] / (reps * N_c),
            "forming_warp_waits_per_step": t[4] / (reps * N_c)})
        del ring, flags, out_c, planes
    # the factored Frechet kernel at K3's and K6's shapes: block 0's
    # cycles per item (step, group), its chunks of directions summed
    frechet_names = {0: "planes_or_E", 1: "load_directions",
                     2: "krylov_chains", 3: "folds", 4: "extension_by_E",
                     5: "traces", 6: "warp_sums_and_store"}
    frechets = []
    for (G, gs) in [(1, 4), (8, 4)]:
        Hs, Os, cs, ts, psis, chis = frechet_inputs(
            rng, dev, d, G, gs, 4, N_T, 10.0, False)
        trj = torch.empty((N_T, G * gs, 4), dtype=torch.complex64,
                          device=dev)
        for s in (0, 1):
            out = (ctypes.c_int * 5)()
            floats = ctypes.c_longlong()
            require(lib.grape_frechet_factored_plan(
                d, 4, gs, s, N_T * G, out, ctypes.byref(floats)) == 0,
                "clocked Frechet plan failed")
            chunk, m_sh, s_sh, smem, blocks = list(out)
            scratch = torch.empty(max(1, blocks * floats.value),
                                  dtype=torch.float32, device=dev)
            t = run(lambda: lib.grape_frechet_factored(
                Hs.data_ptr(), Os.data_ptr(), cs.data_ptr(), ts.data_ptr(),
                psis.data_ptr(), chis.data_ptr(), 4, d, N_T, G * gs, G, gs,
                0, s, chunk, m_sh, s_sh, smem, scratch.data_ptr(),
                floats.value, blocks, trj.data_ptr(), stream),
                lib.grape_frechet_factored_clock)
            items = reps * -(-N_T * G // blocks)
            per_item = {name: t[i] / items
                        for i, name in frechet_names.items()}
            frechets.append({"G": G, "gs": gs, "s": s, "chunk": chunk,
                             "blocks": blocks,
                             "cycles_per_item": per_item,
                             "cycles_per_item_total":
                                 sum(per_item.values())})
            del scratch
        del Hs, Os, cs, ts, psis, chis, trj
    emit({"phase": "cluster_phase_clock", "build_seconds": build_s,
          "resident_clusters": resident, "propagators": props,
          "state_scans": scans, "cheby_ring": rings,
          "frechet_factored": frechets,
          "under_load": under_load(lambda: launch_k1(0), 50)})
    zero_counts(hp)
    torch.cuda.synchronize()


def ensemble_paths(problem, cp, s_ens):
    """Phases ``fg_ensemble`` and ``optimize_ensemble``: the grouped path
    (8 groups of 4) and the per-trajectory path (group size 1), each with
    the launch counts set to 0 just before and read just after.  Returns
    the two count dictionaries."""
    import grape_tpu_torch as gt
    from grape_tpu_torch.fg import (
        _effective_group_size, _gg_u_bytes_ok, _static_squarings,
    )
    from grape_tpu_torch.functionals import make_ensemble_gate_functional
    from grape_tpu_torch.models import two_transmon_cz_ensemble_problem
    from grape_tpu_torch.ops import hopper_cheby, hopper_frechet, hopper_prop

    K, d, N_T, L = cp.n_traj, cp.dim, cp.n_timesteps, cp.n_controls
    x0 = cp.guess_pulsevals.reshape(-1)

    # the per-trajectory problems are built before any count is set to 0:
    # (a) the SAME operators under one generator object per trajectory,
    # (b) 32 samples that really differ, one basis state of each
    rebuilt = [
        gt.Trajectory(t.initial_state,
                      gt.hamiltonian(t.generator.drift, *t.generator.terms),
                      target_state=t.target_state)
        for t in problem.trajectories
    ]
    cp_same = gt.compile_problem(rebuilt, problem.tlist, dtype=np.complex64,
                                 **problem.kwargs)
    wide = two_transmon_cz_ensemble_problem(
        n_samples=K, d=D_TRANSMON, n_steps=N_STEPS, seed=SEED + 1)
    distinct = [wide.trajectories[N_BASIS * i + i % N_BASIS]
                for i in range(K)]
    cp_diff = gt.compile_problem(distinct, wide.tlist, dtype=np.complex64,
                                 J_T=make_ensemble_gate_functional(N_BASIS))
    for c in (cp_same, cp_diff):
        require(c.H0.shape[0] == K and _effective_group_size(c) == 1
                and not c.shared_generator and not _gg_u_bytes_ok(c),
                "the per-trajectory problems must hold K generators and a "
                "propagator stream past its budget")
    require(_gg_u_bytes_ok(cp) and _effective_group_size(cp) == N_BASIS,
            "the grouped problem must keep its propagator stream")

    # a d = 3 ensemble in complex64 through the kernels against complex128
    # plain (Padé-13), both on the card
    small = two_transmon_cz_ensemble_problem(n_samples=3, d=3, n_steps=20,
                                             T=5.0)
    cp64, cp128 = (
        gt.compile_problem(small.trajectories, small.tlist, dtype=dt,
                           **small.kwargs)
        for dt in (np.complex64, np.complex128)
    )
    xs = cp64.guess_pulsevals.reshape(-1)
    Js, gs_, _ = gt.build_fg(cp64)(xs)
    Jr, gr, _ = gt.build_fg(cp128)(xs)
    dJs = abs(float(Js) - float(Jr))
    dgs = float((gs_.double() - gr).abs().max() / gr.abs().max())
    require(dJs < 1e-5 and dgs < 2e-3,
            f"small ensemble: dJ {dJs}, dgrad {dgs}")

    # ---- the grouped path: every count set to 0 just before --------------
    zero_counts(hopper_prop, hopper_frechet, hopper_cheby)
    fg = gt.build_fg(cp)
    J, g, aux, dJ, dg = fg_against_plain(fg, x0, "fg_ensemble")
    n_fg = 1
    require(g.shape == (L * N_T,) and g.device.type == "cuda"
            and aux["psi_T"].shape == (K, d),
            "fg_ensemble output has the wrong shape or device")
    reps = 3
    fg_ms = timed_ms(lambda: fg(x0), reps)
    n_fg += reps
    parts = fg_breakdown(fg, x0)
    n_fg += 4

    series, iter_secs, iter_fg = [], [], []

    def record(wrk, iteration):
        series.append(float(wrk.result.J_T))
        iter_secs.append(float(wrk.result.secs))
        iter_fg.append(int(wrk.fg_count[0]))

    t0 = time.perf_counter()
    res = gt.optimize_problem(
        problem, iter_stop=ITER_STOP, dtype=np.complex64, print_iters=False,
        rethrow_exceptions=True, callback=record,
    )
    torch.cuda.synchronize()
    opt_s = time.perf_counter() - t0
    # one more evaluation at once: a card that lost clock over the run
    # shows it here against ms_per_eval above
    fg_ms_after = timed_ms(lambda: fg(x0), 1)
    counts = read_counts(hopper_prop, hopper_frechet, hopper_cheby)
    n_fg += res.fg_calls + 1
    require(len(series) == ITER_STOP + 1 and res.iter == ITER_STOP,
            f"optimize_ensemble: {res.message}, series {series}")
    require(all(math.isfinite(v) for v in series)
            and all(b < a for a, b in zip(series, series[1:])),
            f"ensemble J_T does not fall monotonically: {series}")
    expect = dict.fromkeys(counts, 0)
    expect.update({"forward_scan_grouped": n_fg + res.f_calls,
                   "chi_scan_grouped": n_fg,
                   "frechet_trace_pertraj_factored": n_fg})
    require(counts == expect, f"ensemble launch counts {counts} do not "
            f"match the evaluations {expect}")

    # ---- the per-trajectory path: counts set to 0 again -------------------
    zero_counts(hopper_prop, hopper_frechet, hopper_cheby)
    J_same, g_same, _ = gt.build_fg(cp_same)(x0)
    torch.cuda.synchronize()
    dJ_same = abs(float(J_same) - float(J))
    dg_same = max_abs(g_same, g) / float(g.abs().max())
    require(dJ_same < 1e-5 and dg_same < 2e-3,
            "one generator per trajectory with the grouped problem's "
            f"operators: dJ {dJ_same}, dgrad {dg_same} against the grouped "
            "path")
    fg_diff = gt.build_fg(cp_diff)
    x_diff = cp_diff.guess_pulsevals.reshape(-1)
    J_d, g_d, _, dJ_d, dg_d = fg_against_plain(fg_diff, x_diff,
                                               "fg_ensemble distinct")
    fg_diff_ms = timed_ms(lambda: fg_diff(x_diff), 2)
    parts_diff = fg_breakdown(fg_diff, x_diff, reps=2)
    Jf, _ = gt.build_f(cp_diff)(x_diff)
    require(abs(float(Jf) - float(J_d)) < 1e-5,
            "build_f disagrees with build_fg on the distinct ensemble")
    counts_k = read_counts(hopper_prop, hopper_frechet, hopper_cheby)
    expect = dict.fromkeys(counts_k, 0)
    expect.update({"forward_scan_pertraj": 8, "chi_scan_recompute": 7,
                   "frechet_trace_pertraj_factored": 7})
    require(counts_k == expect, f"per-trajectory launch counts {counts_k} "
            f"do not match the evaluations {expect}")

    emit({"phase": "fg_ensemble", "J": float(J),
          "grad_norm": float(g.norm()), "ms_per_eval": fg_ms,
          "flop_rate": flop_rate(cp, fg_ms), "device_ms_by_part": parts,
          "J_abs_diff_vs_plain": dJ, "grad_diff_of_max_vs_plain": dg,
          "squarings": s_ens, "dtype": "complex64",
          "small_d3": {"J_complex64_kernels": float(Js),
                       "J_complex128_plain": float(Jr), "J_abs_diff": dJs,
                       "grad_diff_of_max": dgs},
          "per_trajectory": {
              "same_operators_J_abs_diff_vs_grouped": dJ_same,
              "same_operators_grad_diff_of_max_vs_grouped": dg_same,
              "distinct_J": float(J_d), "distinct_ms_per_eval": fg_diff_ms,
              "distinct_flop_rate": flop_rate(cp_diff, fg_diff_ms),
              "distinct_device_ms_by_part": parts_diff,
              "distinct_J_abs_diff_vs_plain": dJ_d,
              "distinct_grad_diff_of_max_vs_plain": dg_d,
              "squarings": _static_squarings(cp_diff),
              "launches": counts_k}})
    steady_s = sum(iter_secs[1:])
    emit({"phase": "optimize_ensemble", "J_T_series": series,
          "iterations": res.iter, "seconds": opt_s,
          "iters_per_second": res.iter / opt_s,
          "iteration_seconds": iter_secs, "iteration_fg_calls": iter_fg,
          "steady_ms_per_fg": steady_s / max(sum(iter_fg[1:]), 1) * 1e3,
          "steady_iters_per_second": ITER_STOP / steady_s,
          "fg_calls": res.fg_calls, "f_calls": res.f_calls,
          "fg_ms_right_after": fg_ms_after,
          "message": res.message, "launches": counts})
    return counts, counts_k, series


# ---- the Chebyshev path (dim 1024) ----------------------------------------

# the reference's dim1024_cz_cheby_taylor row: the CZ register at d = 32
CHEBY_D, CHEBY_STEPS, CHEBY_T = 32, 100, 1.0
# the dim-256 row (d = 16), for the gradgen pass and a third kernel shape
CHEBY256_D, CHEBY256_STEPS, CHEBY256_T = 16, 200, 5.0
SUBSPACE_BASIS = 64


def cheby_flops_bytes(d, K, T, N_T, n_cheby):
    """Float32 operations and bytes of one direction of the Chebyshev scan:
    per step the generator's rows (T real-by-complex axpys and the
    normalisation), per term a complex (d, d) by (d, K) product, the
    recursion's 2 x - y and the weighted sum; each input read once (the
    T + 1 operators, the coefficient, Chebyshev and phase tables, the
    initial states), the (N_T, K, d) output written once."""
    per_term = 8.0 * K * d * d + 12.0 * K * d
    flops = N_T * ((n_cheby - 1) * per_term + (4.0 * T + 4.0) * d * d)
    byts = (8.0 * (T + 1) * d * d + 4.0 * N_T * T + 8.0 * N_T * n_cheby
            + 8.0 * N_T + 8.0 * K * d + 8.0 * N_T * K * d)
    return flops, byts


def cheby_inputs(cp, rng, dev, noise=0.02):
    """The scan's inputs for a compiled shared-generator problem: its
    operators, the coefficient table of the guess plus seeded noise, and the
    tables of ``_cheby_data`` at the default envelope."""
    from grape_tpu_torch.fg import _prop_data, _prop_data_on

    L, N_T = cp.n_controls, cp.n_timesteps
    eps = cp.guess_pulsevals + noise * rng.normal(size=(L, N_T))
    c64 = lambda x: torch.tensor(np.ascontiguousarray(x),
                                 dtype=torch.complex64, device=dev)
    coeffs = torch.tensor(np.einsum("ntl,ln->nt", cp.M, eps) + cp.Mfix,
                          dtype=torch.float32, device=dev)
    pd = _prop_data_on(_prop_data(cp), dev)["fw"]
    return (c64(cp.H0[0]), c64(cp.ops[0]), coeffs, pd), c64(cp.psi0)


def cheby_kernel_phase(cp_cz, cp_sub, cp_256, rng, dev):
    """Phase ``kernel_check_cheby``: ``cheby_scan`` against its plain version
    on the card, forward and adjoint, at the three shapes of the Chebyshev
    paths (the ring kernel its rule takes, and the grid kernel forced) and
    at ragged ones (the rule's kernel), then its times at the main path's
    shape.
    Returns its entry for the kernels line (without the launch count)."""
    from grape_tpu_torch.ops import hopper_cheby as hc
    from grape_tpu_torch.ops import plain_versions

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def both(args, psi0, chi0):
        H0, ops, coeffs, pd = args
        fw = hc.cheby_scan(H0, ops, coeffs, pd["tab_fw_t"], pd["ph_fw_t"],
                           pd["shift"], pd["dE"], psi0)
        bw = hc.cheby_scan(H0, ops, coeffs, pd["tab_bw_t"], pd["ph_bw_t"],
                           pd["shift"], pd["dE"], chi0, adjoint=True)
        return fw, bw

    checks = []
    err = 0.0
    main = {}
    for name, cp in (("cz_dim1024", cp_cz), ("subspace_dim1024", cp_sub),
                     ("cz_dim256", cp_256)):
        args, psi0 = cheby_inputs(cp, rng, dev)
        K, d = psi0.shape
        chi0 = rng.normal(size=(K, d)) + 1j * rng.normal(size=(K, d))
        chi0 = torch.tensor(chi0 / np.linalg.norm(chi0, axis=1,
                                                  keepdims=True),
                            dtype=torch.complex64, device=dev)
        got = both(args, psi0, chi0)
        torch.cuda.synchronize()
        with hc._forced_route("grid"):
            old = both(args, psi0, chi0)
        torch.cuda.synchronize()
        with plain_versions():
            want = both(args, psi0, chi0)
        torch.cuda.synchronize()
        require(finite(*got), f"cheby_scan output not finite at {name}")
        require(all(g.shape == (cp.n_timesteps, K, d) for g in got),
                f"cheby_scan output has the wrong shape at {name}")
        plan = hc.cheby_route(d, K, sms)
        require(plan["route"] == "ring", f"{name} must take the ring kernel")
        e = {"forward": max_abs(got[0], want[0]),
             "adjoint": max_abs(got[1], want[1])}
        e_grid = {"forward": max_abs(old[0], want[0]),
                  "adjoint": max_abs(old[1], want[1])}
        n_cheby = int(args[3]["tab_fw_t"].shape[1])
        checks.append({"shape": name, "d": d, "K": K,
                       "N_T": cp.n_timesteps, "n_cheby": n_cheby,
                       "ring_plan": plan, **e,
                       "grid_kernel": {"layout": hc.cheby_scan_layout(d, K),
                                       **e_grid}})
        require(max(*e.values(), *e_grid.values()) < TOL_STATE,
                f"cheby_scan disagrees with its plain version at {name}: "
                f"ring {e}, grid {e_grid}")
        err = max(err, *e.values())
        if name == "cz_dim1024":
            main = {"args": args, "psi0": psi0, "chi0": chi0,
                    "n_cheby": n_cheby}
    # ragged shapes: d not a multiple of the rows per block, K below and
    # above one shared tile, one step, two or three terms with the last
    # column of the table a zero pad; then three steps where the ring
    # kernel splits K over k-groups (wk 2, 8) and chunks (K = 100), a row
    # per CTA (d = 129), the last d of the ring (1056) and the first past
    # it (1100, the grid kernel)
    shape_checks = []
    for (d_, K_, nc_, N_) in [(257, 3, 2, 1), (300, 1, 3, 1), (1000, 5, 3, 1),
                              (300, 3, 2, 1), (257, 5, 3, 1), (1000, 1, 2, 1),
                              (1024, 16, 3, 3), (1024, 100, 2, 3),
                              (129, 9, 3, 3), (1056, 4, 3, 3),
                              (1100, 3, 2, 3)]:
        A = rng.normal(size=(d_, d_)) + 1j * rng.normal(size=(d_, d_))
        B = rng.normal(size=(2, d_, d_)) + 1j * rng.normal(size=(2, d_, d_))
        c64 = lambda x: torch.tensor(np.ascontiguousarray(x),
                                     dtype=torch.complex64, device=dev)
        H0_ = c64((A + A.conj().T) / np.sqrt(d_))
        ops_ = c64(0.3 * (B + B.conj().transpose(0, 2, 1)) / np.sqrt(d_))
        co_ = torch.tensor(0.3 * rng.normal(size=(N_, 2)),
                           dtype=torch.float32, device=dev)
        tab_ = np.zeros((N_, nc_), dtype=complex)
        tab_[:, :nc_ - 1] = rng.normal(size=(N_, nc_ - 1)) \
            + 1j * rng.normal(size=(N_, nc_ - 1))
        p0 = rng.normal(size=(K_, d_)) + 1j * rng.normal(size=(K_, d_))
        p0 = c64(p0 / np.linalg.norm(p0, axis=1, keepdims=True))
        ph_ = c64(np.exp(0.3j * np.arange(1, N_ + 1)))
        worst = 0.0
        for adj in (False, True):
            call = lambda: hc.cheby_scan(H0_, ops_, co_, c64(tab_), ph_, 0.2,
                                         5.0, p0, adjoint=adj)
            g = call()
            torch.cuda.synchronize()
            with plain_versions():
                w = call()
            worst = max(worst, max_abs(g, w))
        shape_checks.append({"d": d_, "K": K_, "N_T": N_, "n_cheby": nc_,
                             "padded": True, "max_abs_err": worst,
                             "route": hc.cheby_route(d_, K_, sms)["route"]})
        require(worst < TOL_TRJ, "cheby_scan disagrees with its plain "
                f"version at {shape_checks[-1]}")
    emit({"phase": "kernel_check_cheby", "tol": TOL_STATE,
          "tol_ragged": TOL_TRJ, "checks": checks,
          "ragged_checks": shape_checks})

    # ---- times at the main path's shape, each direction apart -------------
    H0, ops, coeffs, pd = main["args"]
    psi0, chi0 = main["psi0"], main["chi0"]
    fw = lambda: hc.cheby_scan(H0, ops, coeffs, pd["tab_fw_t"],
                               pd["ph_fw_t"], pd["shift"], pd["dE"], psi0)
    bw = lambda: hc.cheby_scan(H0, ops, coeffs, pd["tab_bw_t"],
                               pd["ph_bw_t"], pd["shift"], pd["dE"], chi0,
                               adjoint=True)
    out = {"err": err, "ms_runs": [], "ms_adjoint_runs": []}
    out["ms"] = median_ms(fw, runs=out["ms_runs"])
    out["ms_adjoint"] = median_ms(bw, runs=out["ms_adjoint_runs"])
    with plain_versions():
        out["plain_ms"] = median_ms(fw, reps=3)
        out["plain_ms_adjoint"] = median_ms(bw, reps=3)
    # the other two shapes: one timed run each way
    for name, cp in (("subspace_dim1024", cp_sub), ("cz_dim256", cp_256)):
        args_, p0 = cheby_inputs(cp, rng, dev)
        H0_, ops_, co_, pd_ = args_
        out[f"ms_{name}"] = median_ms(
            lambda: hc.cheby_scan(H0_, ops_, co_, pd_["tab_fw_t"],
                                  pd_["ph_fw_t"], pd_["shift"], pd_["dE"],
                                  p0), reps=3)
        out[f"bound_ms_{name}"] = bound(*cheby_flops_bytes(
            cp.dim, p0.shape[0], cp.ops.shape[1], cp.n_timesteps,
            int(pd_["tab_fw_t"].shape[1])))[0]
    out["flops"], out["bytes"] = cheby_flops_bytes(
        cp_cz.dim, psi0.shape[0], ops.shape[0], coeffs.shape[0],
        main["n_cheby"])
    out["per"] = "direction (ms forward; ms_adjoint the co-state chain)"
    out["library_ms"] = None
    out["library_call"] = "none: no single PyTorch call computes the scan"
    return out


def cheby_routes_phase(cp_cz, cp_sub, cp_256, rng, dev):
    """Phase ``cheby_routes``: the ring kernel (``csrc/cheby_ring.cu``) and
    the grid-barrier kernel (``csrc/cheby_scan.cu``) forced in turn on the
    same inputs, both directions: dim 1024 at K = 1, 4, 8 and 64 (the CZ's
    and the subspace gate's operators, the first K of its basis states),
    dim 256, the last d of the ring (1056) and the first past it (1100:
    the grid kernel only).  Each shape names the faster kernel beside the
    rule's; the ring kernel must win at dim 1024, K = 4 both ways and the
    rule must pick the faster kernel everywhere.  Returns the main shape's
    grid times and the per-term times for the kernels line."""
    from grape_tpu_torch.ops import hopper_cheby as hc

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def unit(K, d):
        v = rng.normal(size=(K, d)) + 1j * rng.normal(size=(K, d))
        return torch.tensor(v / np.linalg.norm(v, axis=1, keepdims=True),
                            dtype=torch.complex64, device=dev)

    def random_inputs(d, K, N_T=CHEBY_STEPS, n_cheby=27):
        A = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
        B = rng.normal(size=(2, d, d)) + 1j * rng.normal(size=(2, d, d))
        c64 = lambda x: torch.tensor(np.ascontiguousarray(x),
                                     dtype=torch.complex64, device=dev)
        tab = 0.2 * (rng.normal(size=(N_T, n_cheby))
                     + 1j * rng.normal(size=(N_T, n_cheby)))
        ph = c64(np.exp(0.3j * rng.uniform(size=N_T)))
        pd = {"tab_fw_t": c64(tab), "ph_fw_t": ph, "tab_bw_t": c64(tab),
              "ph_bw_t": ph, "shift": 0.1, "dE": 5.0}
        return (c64(0.5 * (A + A.conj().T) / np.sqrt(d)),
                c64(0.15 * (B + B.conj().transpose(0, 2, 1)) / np.sqrt(d)),
                torch.tensor(0.3 * rng.normal(size=(N_T, 2)),
                             dtype=torch.float32, device=dev), pd)

    args_cz, psi_cz = cheby_inputs(cp_cz, rng, dev)
    args_sub, psi_sub = cheby_inputs(cp_sub, rng, dev)
    args_256, psi_256 = cheby_inputs(cp_256, rng, dev)
    shapes = [
        ("dim1024_K1", args_sub, psi_sub[:1].contiguous()),
        ("dim1024_K4_cz", args_cz, psi_cz),
        ("dim1024_K8", args_sub, psi_sub[:8].contiguous()),
        ("dim1024_K64_subspace", args_sub, psi_sub),
        ("dim256_K4_cz", args_256, psi_256),
        ("edge_d1056_K4", random_inputs(1056, 4), unit(4, 1056)),
        ("past_edge_d1100_K4", random_inputs(1100, 4), unit(4, 1100)),
    ]
    rows = []
    main = {}
    for name, args, psi0 in shapes:
        H0, ops, coeffs, pd = args
        K, d = psi0.shape
        N_T, n_cheby = coeffs.shape[0], int(pd["tab_fw_t"].shape[1])
        chi0 = unit(K, d)
        plan = hc.cheby_route(d, K, sms)
        calls = {
            "forward": lambda: hc.cheby_scan(
                H0, ops, coeffs, pd["tab_fw_t"], pd["ph_fw_t"], pd["shift"],
                pd["dE"], psi0),
            "adjoint": lambda: hc.cheby_scan(
                H0, ops, coeffs, pd["tab_bw_t"], pd["ph_bw_t"], pd["shift"],
                pd["dE"], chi0, adjoint=True),
        }
        routes = ["ring", "grid"] if plan["route"] == "ring" else ["grid"]
        row = {"shape": name, "d": d, "K": K, "N_T": N_T,
               "n_cheby": n_cheby, "rule": plan["route"], "plan": plan,
               "bound_ms": bound(*cheby_flops_bytes(
                   d, K, ops.shape[0], N_T, n_cheby))[0]}
        outs = {}
        for route in routes:
            with hc._forced_route(route):
                for direction, call in calls.items():
                    outs[route, direction] = call()
                    torch.cuda.synchronize()
                    ms = median_ms(call, reps=3)
                    row[f"{route}_ms_{direction}"] = ms
                    row[f"{route}_us_per_term_{direction}"] = (
                        ms * 1e3 / (N_T * (n_cheby - 1)))
        if len(routes) == 2:
            diff = max(max_abs(outs["ring", k], outs["grid", k])
                       for k in calls)
            row["ring_vs_grid_max_abs_diff"] = diff
            require(diff < 2 * TOL_STATE, f"cheby_routes: the two kernels "
                    f"disagree at {name} by {diff}")
        faster = min(routes, key=lambda r: row[f"{r}_ms_forward"]
                     + row[f"{r}_ms_adjoint"])
        row["faster"] = faster
        require(plan["route"] == faster, f"cheby_routes: the rule takes "
                f"{plan['route']} at {name}, the faster kernel is {faster}")
        rows.append(row)
        if name == "dim1024_K4_cz":
            require(all(row[f"ring_ms_{k}"] < row[f"grid_ms_{k}"]
                        for k in calls),
                    f"the ring kernel is not faster at dim 1024, K = 4: {row}")
            main = {"grid_ms": row["grid_ms_forward"],
                    "grid_ms_adjoint": row["grid_ms_adjoint"],
                    "us_per_term": row["ring_us_per_term_forward"],
                    "grid_us_per_term": row["grid_us_per_term_forward"]}
        if name == "dim1024_K64_subspace":
            main.update(ms_subspace_dim1024_grid=row["grid_ms_forward"])
        if name == "dim256_K4_cz":
            main.update(ms_cz_dim256_grid=row["grid_ms_forward"])
    emit({"phase": "cheby_routes", "tol_ring_vs_grid": 2 * TOL_STATE,
          "sm_count": sms, "shapes": rows})
    return main

# the Taylor-order kernel's ragged shapes: (d, N_T, G, gs, L, T,
# per-trajectory tables) — a ragged row tile and chunk, one table a
# trajectory, N_T not a multiple of 8, three groups, one and three
# controls
TAYLOR_ORDER_SHAPES = (
    (136, 10, 2, 2, 4, 4, False), (130, 9, 2, 1, 4, 4, True),
    (200, 17, 1, 4, 2, 2, False), (258, 8, 3, 2, 2, 2, False),
    (1000, 12, 1, 4, 4, 4, False), (150, 11, 1, 4, 3, 3, False),
    (144, 5, 2, 2, 1, 1, False), (132, 7, 3, 1, 3, 3, True),
)
# the order count of cz1024.cheby's passes (the benchmark's mean)
CZ1024_ORDERS = 52


def taylor_order_phase(rng, dev):
    """Phase ``taylor_order``: the Taylor-order kernel
    (``csrc/taylor_order.cu``) against its plain version and against the
    static-operator einsum pass it replaced.

    ``passes``: the CZ at dim 1024 (cz1024.cheby's shapes: K = 4, L = T =
    4, N_T = 100, 52 orders) and at dim 256 (N_T = 200, the guess's order
    count), pulses at the guess plus seeded noise, seeded co-states and
    states: the whole pass of ``fg._backward_vectorized`` on the kernel's
    route against the same pass with the plain order (``plain_versions``)
    and with the route forced to the static einsums; ms an order of the
    kernel (a loop of its launches alone), of the static pass
    (``library_ms``) and the plain pass, the bound (the needed operations
    at 67 TFLOP/s), the kernel's own operations, the counters (launches,
    ``taylor_orders["kernel"]``) and the last wave's split timed at 1, 3,
    5 and 8 ranges.
    ``shapes``: eight ragged layouts, ``M`` orders by direct launches,
    acc, φ and Hm against the plain version, with the plan's split and
    with the last wave's tiles forced into three ranges.
    ``kernel_share``: the share of the orders the kernel runs in one
    gradient evaluation of each large-d Taylor configuration the repo runs,
    with its layouts.  Returns the kernels line's entry (an order at
    cz1024.cheby's shapes)."""
    import ctypes

    import grape_tpu_torch as gt
    import grape_tpu_torch.fg as F
    from grape_tpu_torch.models import two_transmon_cz_problem
    from grape_tpu_torch.ops import _build, hopper_taylor, plain_versions

    c64 = torch.complex64
    # the layout rule's shared bytes and sums against the built kernel's
    lib = _build.load_kernels()
    for gs, L, T in sorted(hopper_taylor.TAYLOR_LAYOUTS):
        out = (ctypes.c_int * 2)()
        require(lib.grape_taylor_order_plan(gs, L, T, out) == 0,
                f"the Taylor-order kernel is not built for {(gs, L, T)}")
        plan = hopper_taylor.taylor_plan(1024, 100, 1, gs, L, T)
        require((plan["smem"], plan["sums"]) == tuple(out),
                f"layout {(gs, L, T)}: rule {plan}, kernel {list(out)}")
    passes = []
    for name, (dlev, steps, T_end, orders) in (
            ("cz1024", (CHEBY_D, CHEBY_STEPS, CHEBY_T, CZ1024_ORDERS)),
            ("d256", (CHEBY256_D, CHEBY256_STEPS, CHEBY256_T, None))):
        problem = two_transmon_cz_problem(d=dlev, n_steps=steps, T=T_end)
        kwargs = dict(problem.kwargs, prop_method="cheby",
                      gradient_method="taylor")
        cp = gt.compile_problem(problem.trajectories, problem.tlist,
                                dtype=np.complex64, **kwargs)
        consts = F._device_constants(cp, dev)
        d, K, N, L = cp.dim, cp.n_traj, cp.n_timesteps, cp.n_controls
        G, T = consts["ops"].shape[0], consts["ops"].shape[1]
        M = orders or F._vectorized_taylor_orders(cp)
        require(F._taylor_pass_route(d, K, G, L, T, c64, "cuda") == "kernel",
                f"{name}: the pass must take the Taylor-order kernel")
        eps = cp.guess_pulsevals + 0.3 * rng.normal(size=(L, N))
        coeffs, dM = F._coeff_tables(
            cp, consts, torch.as_tensor(eps, dtype=torch.float32,
                                        device=dev))

        def unit(shape):
            v = (torch.randn(shape, dtype=torch.float32, device=dev)
                 + 1j * torch.randn(shape, dtype=torch.float32, device=dev))
            return (v / v.norm(dim=-1, keepdim=True)).to(c64).contiguous()

        torch.manual_seed(int(rng.integers(1 << 30)))
        psis, chis = unit((N, K, d)), unit((N, K, d))
        rho = torch.ones(K, dtype=torch.float32, device=dev)
        args = (cp, consts, coeffs, dM, psis, chis, rho, None, M)

        hopper_taylor.launches["taylor_order"] = 0
        k0 = F.taylor_orders["kernel"]
        g_k, ok_k = F._backward_vectorized(*args)
        torch.cuda.synchronize()
        counts = {"launches": hopper_taylor.launches["taylor_order"],
                  "taylor_orders_kernel": F.taylor_orders["kernel"] - k0,
                  "orders": M}
        require(counts["launches"] == M and counts["taylor_orders_kernel"]
                == M, f"{name}: one launch an order: {counts}")
        pass_ms = median_ms(lambda: F._backward_vectorized(*args), reps=5)
        with plain_versions():
            g_p, ok_p = F._backward_vectorized(*args)
            plain_ms = median_ms(lambda: F._backward_vectorized(*args),
                                 reps=1)
        route = F._taylor_pass_route
        F._taylor_pass_route = lambda *a: "static"
        try:
            g_s, ok_s = F._backward_vectorized(*args)
            library_ms = median_ms(lambda: F._backward_vectorized(*args),
                                   reps=3)
        finally:
            F._taylor_pass_route = route
        # the same pass in complex128 (the static einsums: complex128
        # takes no kernel), the yardstick of the three float32 passes
        c128 = torch.complex128
        consts128 = dict(consts, H0=consts["H0"].to(c128),
                         ops=consts["ops"].to(c128), cdtype=c128,
                         dt=consts["dt"].double())
        g_x, _ = F._backward_vectorized(
            cp, consts128, coeffs.double(), dM.double(), psis.to(c128),
            chis.to(c128), rho.double(), None, M)
        torch.cuda.synchronize()
        for g in (g_k, g_p, g_s):
            require(bool(torch.isfinite(torch.view_as_real(g)).all()),
                    f"{name}: a pass is not finite")
        scale = float(g_x.abs().max())
        errs = {"kernel_vs_plain": max_abs(g_k, g_p) / scale,
                "kernel_vs_static": max_abs(g_k, g_s) / scale,
                "static_vs_plain": max_abs(g_s, g_p) / scale,
                "kernel_vs_complex128": max_abs(g_k.to(c128), g_x) / scale,
                "plain_vs_complex128": max_abs(g_p.to(c128), g_x) / scale,
                "static_vs_complex128": max_abs(g_s.to(c128), g_x) / scale}
        emit({"phase": "taylor_order_errors", "name": name, **errs})
        require(bool(ok_k) and bool(ok_p) and bool(ok_s),
                f"{name}: a pass did not converge")
        # each float32 pass against complex128: the kernel's sums may not
        # stray further than twice the farther of the other two
        require(errs["kernel_vs_complex128"] < 2 * max(
            errs["plain_vs_complex128"], errs["static_vs_complex128"]),
            f"{name}: {errs}")
        # the orders alone: the kernel's launches back to back
        h = max(F._h_norm_bound(cp, None), 1e-30)
        co32, dM32 = coeffs.float().contiguous(), dM.float().contiguous()
        H0, ops = consts["H0"], consts["ops"]
        dts = consts["dt"].float()

        def run_orders(work=None):
            return hopper_taylor.taylor_pass(H0, ops, co32, dM32, chis, dts,
                                             h, M, False, work=work)

        layouts = {}
        for kp in (1, 3, 5, 8):
            work = hopper_taylor.order_workspace(d, N, G, K // G, L, T, dev,
                                                 kparts=kp)
            layouts[f"kparts{kp}"] = median_ms(lambda: run_orders(work),
                                               reps=3) / M
        order_ms = median_ms(run_orders, reps=5) / M
        needed = N * (K * (L + 1) + K * L) * 8.0 * d * d
        done = N * G * d * d * (2.0 * T + 4.0 * (K // G) * (L + 1 + T)) * 2
        plan = hopper_taylor.taylor_plan(d, N, G, K // G, L, T,
                                         torch.cuda.get_device_properties(
                                             dev).multi_processor_count)
        passes.append({
            "name": name, "d": d, "K": K, "L": L, "T": T, "N_T": N,
            "orders": M, "plan": plan, "errors": errs,
            "ms_per_order": order_ms,
            "bound_ms_per_order": needed / 67e12 * 1e3,
            "needed_gflop_per_order": needed / 1e9,
            "kernel_gflop_per_order": done / 1e9,
            "roofline_pct": needed / 67e12 * 1e3 / order_ms * 100,
            "pass_ms": pass_ms, "library_ms_per_order": library_ms / M,
            "library_pass_ms": library_ms,
            "plain_ms_per_order": plain_ms / M, "layouts_ms": layouts,
            "counts": counts})
    shapes = []
    for d, N, G, gs, L, T, per in TAYLOR_ORDER_SHAPES:
        K = G * gs
        Gc = K if per else G

        def herm(*shape, scale=1.0):
            A = torch.randn(*shape, d, d, dtype=c64, device=dev)
            return scale * (A + A.conj().transpose(-1, -2)) / (2 * d ** 0.5)

        H0, ops = herm(Gc), herm(Gc, T, scale=0.5)
        co = torch.randn(*((Gc,) if per else ()), N, T, device=dev)
        dM = torch.randn(*((Gc,) if per else ()), N, T, L, device=dev)
        chis = torch.randn(N, K, d, dtype=c64, device=dev)
        chis = chis / chis.norm(dim=-1, keepdim=True)
        dts = torch.full((N,), 0.05, device=dev)
        h = float(H0.abs().sum(-2).amax() + co.abs().amax()
                  * ops.abs().sum(-2).amax(-1).sum(-1).amax())
        M = 12
        with plain_versions():
            ref = hopper_taylor.taylor_pass(H0, ops, co, dM, chis, dts, h, M,
                                            per, hm_last=True)[:3]
        row = {"d": d, "N_T": N, "G": Gc, "gs": 1 if per else gs, "L": L,
               "T": T, "per": per, "orders": M}
        for label, kp in (("plan", None), ("kparts3", 3)):
            work = hopper_taylor.order_workspace(d, N, Gc, 1 if per else gs,
                                                 L, T, dev, kparts=kp)
            plan = work[0]
            got = hopper_taylor.taylor_pass(H0, ops, co, dM, chis, dts, h, M,
                                            per, work=work,
                                            hm_last=True)[:3]
            torch.cuda.synchronize()
            errs = [max_abs(a, b) / max(float(b.abs().max()), 1e-30)
                    for a, b in zip(got, ref)]
            require(max(errs) < TOL_TRJ,
                    f"Taylor order at {row} ({label}): errors {errs}")
            row[label] = {"kparts": plan["kparts"], "full": plan["full"],
                          "tiles": plan["tiles"], "acc_phi_hm_err": errs}
        shapes.append(row)
    # the share of orders the kernel runs on the paths of the large-d
    # Taylor configurations the repo runs (one gradient evaluation each at
    # the guess): the benchmark's two Taylor cells (cz.taylor at dim 100:
    # the formed-H_n branch), the mixed dim-1024 CZ (PERF.md's cell still to
    # come: two partitions of two basis states), the CZ at dim 144 and 256,
    # and 64 basis states at dim 1024 (too many columns: formed)
    from grape_tpu_torch.fg_hetero import (
        compile_heterogeneous, traj_prop_partition,
    )
    from grape_tpu_torch.models import two_transmon_subspace_gate_problem

    def compiled(problem, **kw):
        return gt.compile_problem(problem.trajectories, problem.tlist,
                                  dtype=np.complex64,
                                  **dict(problem.kwargs, **kw))

    cheby_taylor = dict(prop_method="cheby", gradient_method="taylor")
    trajs, tlist, kw, _ = hetero_problem(CHEBY_D, CHEBY_STEPS, CHEBY_T)
    configs = {
        "cz1024.cheby": compiled(two_transmon_cz_problem(
            d=CHEBY_D, n_steps=CHEBY_STEPS, T=CHEBY_T), **cheby_taylor),
        "cz.taylor": compiled(two_transmon_cz_problem(
            d=D_TRANSMON, n_steps=N_STEPS), gradient_method="taylor"),
        "mixed1024.taylor": compile_heterogeneous(
            trajs, tlist, traj_prop_partition(trajs, kw),
            dtype=np.complex64, **kw),
        "cz_dim144.taylor": compiled(two_transmon_cz_problem(
            d=DIM144_LEVELS), gradient_method="taylor"),
        "cz_dim256.cheby": compiled(two_transmon_cz_problem(
            d=CHEBY256_D, n_steps=CHEBY256_STEPS, T=CHEBY256_T),
            **cheby_taylor),
        "subspace1024.cheby": compiled(two_transmon_subspace_gate_problem(
            d=CHEBY_D, n_basis=SUBSPACE_BASIS, n_steps=CHEBY_STEPS,
            T=CHEBY_T), **cheby_taylor),
    }
    share = {}
    for name, cp in configs.items():
        parts = getattr(cp, "parts", [cp])
        before = dict(F.taylor_orders)
        gt.build_fg(cp)(cp.guess_pulsevals.reshape(-1))
        torch.cuda.synchronize()
        got = {k: F.taylor_orders[k] - before[k] for k in ("total", "kernel")}
        share[name] = {
            **got, "share": got["kernel"] / max(got["total"], 1),
            "layouts": [{"d": q.dim, "K": q.n_traj, "L": q.n_controls,
                         "T": int(q.ops.shape[-3]),
                         "gs": q.n_traj // int(q.H0.shape[0])}
                        for q in parts]}
    want = {"cz1024.cheby": 1.0, "cz.taylor": 0.0, "mixed1024.taylor": 1.0,
            "cz_dim144.taylor": 1.0, "cz_dim256.cheby": 1.0,
            "subspace1024.cheby": 0.0}
    require(all(share[k]["share"] == v and share[k]["total"] > 0
                for k, v in want.items()),
            f"the kernel's share of the orders: {share}")
    emit({"phase": "taylor_order", "passes": passes, "shapes": shapes,
          "kernel_share": share})
    # the kernels line's entry: an order at cz1024.cheby's shapes
    main = passes[0]
    d, K, L, T, N = (main[k] for k in ("d", "K", "L", "T", "N_T"))
    return {
        "err": main["errors"]["kernel_vs_plain"],
        "ms": main["ms_per_order"],
        "plain_ms": main["plain_ms_per_order"],
        "flops": main["needed_gflop_per_order"] * 1e9,
        # the operators once, φ and Hm read and written, the sum read and
        # written
        "bytes": 8.0 * ((T + 1) * d * d + N * K * d * (4 * L + 2)),
        "library_ms": main["library_ms_per_order"],
        "library_call": "the static-operator einsum order of "
                        "fg._backward_vectorized (cuBLAS), the route it "
                        "replaced",
        "per": "one order at d = 1024, N_T = 100, K = L = T = 4",
        "passes": passes, "kernel_share": share}


def cheby_paths(rng, dev):
    """The fourth path: phases ``kernel_check_cheby``, ``fg_cheby``,
    ``optimize_cheby`` (the CZ at dim 1024 under Chebyshev propagation, the
    taylor gradient), ``fg_cheby_subspace`` (K = 64) and
    ``fg_cheby_gradgen`` (dim 256, the per-step extended-state pass); the
    main run with the counts set to 0 just before and read just after.
    Returns ``(the kernel's entry for the kernels line, the counts)``."""
    import grape_tpu_torch as gt
    import grape_tpu_torch.fg as F
    from grape_tpu_torch.models import (
        two_transmon_cz_problem, two_transmon_subspace_gate_problem,
    )
    from grape_tpu_torch.ops import (
        hopper_cheby, hopper_frechet, hopper_prop, hopper_taylor,
        plain_forced,
    )

    modules = (hopper_prop, hopper_frechet, hopper_cheby, hopper_taylor)

    def compiled(problem, dtype=np.complex64, **kw):
        kwargs = dict(problem.kwargs, prop_method="cheby")
        kwargs.update(kw)
        return gt.compile_problem(problem.trajectories, problem.tlist,
                                  dtype=dtype, **kwargs)

    # the reference's row names the taylor gradient; "auto" resolves to it
    # under Chebyshev propagation (the default of compile_problem is
    # gradgen)
    problem = two_transmon_cz_problem(d=CHEBY_D, n_steps=CHEBY_STEPS,
                                      T=CHEBY_T, prop_method="cheby",
                                      gradient_method="auto")
    cp = compiled(problem)
    sub = two_transmon_subspace_gate_problem(
        d=CHEBY_D, n_basis=SUBSPACE_BASIS, n_steps=CHEBY_STEPS, T=CHEBY_T,
        gradient_method="auto")
    cp_sub = compiled(sub)
    p256 = two_transmon_cz_problem(d=CHEBY256_D, n_steps=CHEBY256_STEPS,
                                   T=CHEBY256_T)
    cp_256 = compiled(p256, gradient_method="taylor")
    d, K, N_T, L = cp.dim, cp.n_traj, cp.n_timesteps, cp.n_controls
    pds = F._prop_data(cp)
    n_orders = F._vectorized_taylor_orders(cp)
    require((d, K, cp.ops.shape[1], L, N_T) == (1024, 4, 4, 4, 100)
            and cp.shared_generator and cp.gradient_method == "taylor"
            and F._cheby_kernel_enabled(cp, pds["fw"])
            and F._cheby_kernel_enabled(cp, pds["bw"])
            and not F._reuse_U_enabled(cp),
            "the dim-1024 CZ must take the Chebyshev-scan kernel both ways "
            "with the taylor gradient")
    require(pds["fw"]["tab_fw"].shape[1] == 27 and n_orders == 44,
            f"n_cheby {pds['fw']['tab_fw'].shape[1]}, Taylor orders "
            f"{n_orders}: expected 27 and 44")
    k8 = cheby_kernel_phase(cp, cp_sub, cp_256, rng, dev)
    k8.update(cheby_routes_phase(cp, cp_sub, cp_256, rng, dev))
    x0 = cp.guess_pulsevals.reshape(-1)

    # ---- side check before the counted run: complex64 against complex128
    # (the plain series: complex128 takes no kernel), both on the card
    cp128 = compiled(problem, dtype=np.complex128)
    J128, g128, aux128 = gt.build_fg(cp128)(x0)
    torch.cuda.synchronize()

    # ---- the counted run: fg, then five iterations ------------------------
    zero_counts(*modules)
    for key in hopper_cheby.launches_by_direction:
        hopper_cheby.launches_by_direction[key] = 0
    # every Taylor pass of the run: (under plain_versions, its orders)
    by_order = F._taylor_pass_by_order
    passes = []

    def pass_counted(*args):
        passes.append((plain_forced(), args[-1]))
        return by_order(*args)

    F._taylor_pass_by_order = pass_counted
    orders0 = dict(F.taylor_orders)
    fg = gt.build_fg(cp)
    J, g, aux, dJ, dg = fg_against_plain(fg, x0, "fg_cheby")
    n_fg = 1
    require(abs(float(J) - 0.749439) < 1e-5,
            f"fg_cheby: J = {float(J)} at the guess, expected 0.749439")
    require(g.shape == (L * N_T,) and g.device.type == "cuda"
            and aux["psi_T"].shape == (K, d) and bool(aux["taylor_ok"]),
            "fg_cheby output has the wrong shape or device, or the Taylor "
            "series did not converge")
    dJ128 = abs(float(J) - float(J128))
    dg128 = float((g.double() - g128).abs().max() / g128.abs().max())
    require(dJ128 < 1e-5 and dg128 < 1e-3 and bool(aux128["taylor_ok"]),
            f"fg_cheby complex64 vs complex128: dJ {dJ128}, dgrad {dg128}")
    by_dir = dict(hopper_cheby.launches_by_direction)
    require(by_dir == {"forward": 1, "adjoint": 1},
            f"one fg_cheby evaluation launched {by_dir}")
    reps = 3
    fg_ms = timed_ms(lambda: fg(x0), reps)
    n_fg += reps
    parts = fg_breakdown(fg, x0)
    n_fg += 4
    Jf, _ = gt.build_f(cp)(x0)
    n_f = 1
    require(abs(float(Jf) - float(J)) < 1e-6,
            "build_f disagrees with build_fg on the dim-1024 CZ")
    emit({"phase": "fg_cheby", "J": float(J), "grad_norm": float(g.norm()),
          "ms_per_eval": fg_ms, "flop_rate": flop_rate(cp, fg_ms),
          "device_ms_by_part": parts,
          "J_abs_diff_vs_plain": dJ, "grad_diff_of_max_vs_plain": dg,
          "n_cheby": int(pds["fw"]["tab_fw"].shape[1]),
          "dE": pds["fw"]["dE"], "shift": pds["fw"]["shift"],
          "taylor_orders": n_orders, "taylor_ok": bool(aux["taylor_ok"]),
          "dtype": "complex64",
          "vs_complex128": {"J_complex128": float(J128), "J_abs_diff": dJ128,
                            "grad_diff_of_max": dg128},
          "launches_one_eval": by_dir})

    series, iter_secs, iter_fg, wrks = [], [], [], []

    def record(wrk, iteration):
        series.append(float(wrk.result.J_T))
        iter_secs.append(float(wrk.result.secs))
        iter_fg.append(int(wrk.fg_count[0]))
        wrks[:] = [wrk]

    t0 = time.perf_counter()
    try:
        res = gt.optimize_problem(problem, iter_stop=ITER_STOP,
                                  print_iters=False, rethrow_exceptions=True,
                                  callback=record)
        torch.cuda.synchronize()
    finally:
        F._taylor_pass_by_order = by_order
    opt_s = time.perf_counter() - t0
    counts = read_counts(*modules)
    routes_cheby = ROUTE_READS[-1][1]
    orders_run = {k: F.taylor_orders[k] - orders0[k]
                  for k in ("total", "kernel")}
    by_dir = dict(hopper_cheby.launches_by_direction)
    n_fg += res.fg_calls
    n_f += res.f_calls
    # T = 1 is far too short for a CZ at a coupling of 0.05: J_T moves by
    # about 1e-7 per iteration, at the resolution of a float32 J, and
    # L-BFGS-B may stop early by its relative-reduction test
    require(res.iter >= 1 and len(series) == res.iter + 1
            and (res.iter == ITER_STOP
                 or res.message.startswith("CONVERGENCE")),
            f"optimize_cheby: {res.message}, series {series}")
    require(all(math.isfinite(v) for v in series)
            and all(b <= a for a, b in zip(series, series[1:]))
            and series[-1] < series[0],
            f"dim-1024 J_T does not fall monotonically: {series}")
    # one Taylor pass a gradient evaluation, each on the kernel's route
    # (one launch an order), and the plain evaluation's pass beside them
    kernel_orders = [m for plain, m in passes if not plain]
    expect = dict.fromkeys(counts, 0)
    expect["cheby_scan"] = 2 * n_fg + n_f
    expect["taylor_order"] = sum(kernel_orders)
    require(counts == expect and by_dir == {"forward": n_fg + n_f,
                                            "adjoint": n_fg}
            and routes_cheby["cheby_ring"] == expect["cheby_scan"]
            and routes_cheby["cheby_grid"] == 0
            and len(kernel_orders) == n_fg
            and min(kernel_orders) >= n_orders
            and orders_run == {"total": sum(m for _, m in passes),
                               "kernel": sum(kernel_orders)},
            f"dim-1024 launch counts {counts} {by_dir} {routes_cheby} "
            f"(Taylor passes {passes}, orders {orders_run}) do not match "
            f"the evaluations: {n_fg} fg, {n_f} f")
    steady_s = sum(iter_secs[1:])
    emit({"phase": "optimize_cheby", "J_T_series": series,
          "iterations": res.iter, "seconds": opt_s,
          "iters_per_second": res.iter / opt_s,
          "iteration_seconds": iter_secs, "iteration_fg_calls": iter_fg,
          "steady_ms_per_fg": steady_s / max(sum(iter_fg[1:]), 1) * 1e3,
          "steady_iters_per_second": (res.iter / steady_s if steady_s
                                      else None),
          "fg_calls": res.fg_calls, "f_calls": res.f_calls,
          "J_T_fall": series[0] - series[-1],
          "envelope_bucket_growths": len(wrks[0]._program_cache) - 1,
          "envelope_bucket": [float(a) for a in wrks[0]._amp_bucket],
          "message": res.message, "launches": counts,
          "launches_by_direction": by_dir,
          "route_launches": {k: routes_cheby[k]
                             for k in ("cheby_ring", "cheby_grid")},
          "taylor_orders": {**orders_run, "passes": len(passes),
                            "kernel_passes": len(kernel_orders),
                            "orders_min_max": [min(kernel_orders),
                                               max(kernel_orders)]}})

    def ring_run(what):
        """The counted run's launches, which must all have taken the ring
        kernel (route counts read with them)."""
        c = read_counts(*modules)
        routes = ROUTE_READS[-1][1]
        require(routes["cheby_ring"] == c["cheby_scan"] >= 1
                and routes["cheby_grid"] == 0,
                f"{what}: {c['cheby_scan']} scans, routes {routes}")
        return {k: routes[k] for k in ("cheby_ring", "cheby_grid")}

    # ---- K = 64 basis states under the same generator ---------------------
    x_sub = cp_sub.guess_pulsevals.reshape(-1)
    zero_counts(*modules)
    fg_sub = gt.build_fg(cp_sub)
    J_s, g_s, aux_s, dJ_s, dg_s = fg_against_plain(fg_sub, x_sub,
                                                   "fg_cheby_subspace")
    require(abs(float(J_s) - 0.999756) < 1e-5 and bool(aux_s["taylor_ok"])
            and cp_sub.gradient_method == "taylor",
            f"fg_cheby_subspace: J = {float(J_s)}, expected 0.999756")
    sub_ms = timed_ms(lambda: fg_sub(x_sub), 2)
    parts_sub = fg_breakdown(fg_sub, x_sub, reps=2)
    routes_sub = ring_run("fg_cheby_subspace")
    emit({"phase": "fg_cheby_subspace", "K": cp_sub.n_traj, "J": float(J_s),
          "route_launches": routes_sub,
          "taylor_orders": F._vectorized_taylor_orders(cp_sub),
          "ms_per_eval": sub_ms, "flop_rate": flop_rate(cp_sub, sub_ms),
          "device_ms_by_part": parts_sub,
          "J_abs_diff_vs_plain": dJ_s, "grad_diff_of_max_vs_plain": dg_s,
          "taylor_ok": bool(aux_s["taylor_ok"])})

    # ---- dim 256: the per-step extended-state gradgen pass ----------------
    cp_gg = compiled(p256, gradient_method="gradgen")
    require(cp_gg.gradient_method == "gradgen"
            and F._cheby_kernel_enabled(cp_gg, F._prop_data(cp_gg)["fw"])
            and not F._vec_gradgen_enabled(cp_gg),
            "the dim-256 gradgen problem must take the forward kernel and "
            "the per-step extended-state pass")
    x256 = cp_gg.guess_pulsevals.reshape(-1)
    zero_counts(*modules)
    fg_gg, fg_tl = gt.build_fg(cp_gg), gt.build_fg(cp_256)
    J_gg, g_gg, aux_gg, dJ_gg, dg_gg = fg_against_plain(fg_gg, x256,
                                                        "fg_cheby_gradgen")
    J_tl, g_tl, _ = fg_tl(x256)
    d_gt = max_abs(g_gg, g_tl) / float(g_tl.abs().max())
    require(abs(float(J_gg) - float(J_tl)) < 1e-5 and d_gt < 1e-3,
            f"dim 256: gradgen and taylor gradients differ by {d_gt} of the "
            "max")
    gg_ms = timed_ms(lambda: fg_gg(x256), 2)
    tl_ms = timed_ms(lambda: fg_tl(x256), 3)
    routes_256 = ring_run("fg_cheby_gradgen")
    emit({"phase": "fg_cheby_gradgen", "dim": cp_gg.dim,
          "N_T": cp_gg.n_timesteps,
          "n_cheby": int(F._prop_data(cp_gg)["fw"]["tab_fw"].shape[1]),
          "J": float(J_gg), "gradgen_ms_per_eval": gg_ms,
          "taylor_ms_per_eval": tl_ms,
          "gradgen_flop_rate": flop_rate(cp_gg, gg_ms),
          "taylor_flop_rate": flop_rate(cp_256, tl_ms),
          "route_launches": routes_256,
          "grad_diff_of_max_vs_taylor": d_gt,
          "J_abs_diff_vs_plain": dJ_gg, "grad_diff_of_max_vs_plain": dg_gg})
    k8["routes_counted_runs"] = {"optimize_cheby": routes_cheby["cheby_ring"],
                                 "fg_cheby_subspace": routes_sub["cheby_ring"],
                                 "fg_cheby_gradgen": routes_256["cheby_ring"]}
    return k8, counts


# ---- the last two TPU kernels: K10 and K11 ---------------------------------

# K11's probe shapes (the reference's) and its kernel check
PROBE_BATCH, PROBE_REPS = 512, 256
KARATSUBA_CHECK_BATCH, KARATSUBA_CHECK_REPS = 8, 16
# kernel against plain, relative to max|c|: float32 FMAs on both sides, and
# the TF32 path (operands rounded to 10 mantissa bits, 2^-11 = 4.9e-4 each)
# against the float32 plain version over 16 chained products
TOL_KARATSUBA = {"highest": 1e-5, "default": 1e-2}
PEAK_TF32_FLOPS = 495e12


def time_grid_kernel_phase(cp_ens, s_ens, rng, dev):
    """Phase ``kernel_check_time``: ``forward_scan_time`` (K10) against its
    plain version at K = 4, d = 100, T = 4, N_T = 2000 with one generator
    per trajectory (four of the ensemble's Hamiltonian samples), and at
    ragged shapes (K 1, 3 and 256; d 2, 3, 8, 130; N_T 1; the last on the
    small-dimension route), with its time beside ``forward_scan_pertraj(...,
    with_propagators=False)`` on the same inputs.  Its counted run is the
    timed launches.  Returns the kernel line's numbers and the counts."""
    from grape_tpu_torch.ops import (
        hopper_cheby, hopper_frechet, hopper_matmul, hopper_prop,
        plain_versions,
    )

    c64 = lambda x: torch.tensor(x, dtype=torch.complex64, device=dev)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    K, d, N_T = 4, cp_ens.dim, cp_ens.n_timesteps
    T, L = cp_ens.ops.shape[1], cp_ens.n_controls
    H0, ops = c64(cp_ens.H0[:K]), c64(cp_ens.ops[:K])
    eps = cp_ens.guess_pulsevals + 0.02 * rng.normal(size=(L, N_T))
    coeffs = f32(np.einsum("ntl,ln->nt", cp_ens.M, eps) + cp_ens.Mfix)
    dts = f32(np.diff(cp_ens.tlist))
    psi0 = c64(cp_ens.psi0[:K])
    s = s_ens
    st = hopper_prop.forward_scan_time(H0, ops, coeffs, dts, psi0, s)
    torch.cuda.synchronize()
    with plain_versions():
        st_p = hopper_prop.forward_scan_time(H0, ops, coeffs, dts, psi0, s)
    require(finite(st) and st.shape == (N_T + 1, K, d),
            "forward_scan_time output is not finite or has the wrong shape")
    err = max_abs(st, st_p)
    require(err < TOL_STATE, f"forward_scan_time disagrees: {err}")
    shape_checks = []
    for (d_, K_, T_, N_, s_, h_) in [(2, 1, 1, 300, 0, 5.0),
                                     (8, 3, 2, 40, 2, 20.0),
                                     (130, 3, 2, 5, 1, 20.0),
                                     (64, 1, 3, 1, 3, 50.0),
                                     (3, 256, 2, 50, 1, 5.0)]:
        Hs, Os, cs, ts, p0, _ = random_group_inputs(rng, dev, d_, K_, 1, T_,
                                                    N_, h_, False)
        out = hopper_prop.forward_scan_time(Hs, Os, cs, ts, p0, s_)
        torch.cuda.synchronize()
        with plain_versions():
            ref = hopper_prop.forward_scan_time(Hs, Os, cs, ts, p0, s_)
        e = max_abs(out, ref)
        shape_checks.append({"d": d_, "K": K_, "T": T_, "N_T": N_, "s": s_,
                             "route": "small-d" if d_ <= 4 and K_ >= 128
                             else "large-d",
                             "propagator_route":
                                 hopper_prop.propagator_route(d_),
                             "max_abs_err": e})
        require(e < TOL_TRJ, f"forward_scan_time disagrees at "
                f"{shape_checks[-1]}")

    # the counted run: the wrapper as a caller drives it, timed
    zero_counts(hopper_prop, hopper_frechet, hopper_cheby, hopper_matmul)
    ms = median_ms(lambda: hopper_prop.forward_scan_time(
        H0, ops, coeffs, dts, psi0, s))
    counts = read_counts(hopper_prop, hopper_frechet, hopper_cheby,
                         hopper_matmul)
    expect = dict.fromkeys(counts, 0)
    expect["forward_scan_time"] = 6
    require(counts == expect, f"kernel_check_time launch counts {counts}")
    pertraj_ms = median_ms(lambda: hopper_prop.forward_scan_pertraj(
        H0, ops, coeffs, dts, psi0, s, with_propagators=False))
    with plain_versions():
        plain_ms = median_ms(lambda: hopper_prop.forward_scan_time(
            H0, ops, coeffs, dts, psi0, s), reps=1)
    A_lib = ((-1j * dts.to(torch.complex64))[:, None, None, None] * (
        H0[None] + torch.einsum("nt,ktij->nkij", coeffs.to(torch.complex64),
                                ops))).reshape(-1, d, d)
    library_ms = median_ms(lambda: torch.linalg.matrix_exp(A_lib), reps=3)
    del A_lib
    cmm = 8.0 * d ** 3
    emit({"phase": "kernel_check_time",
          "shape": {"d": d, "K": K, "T": T, "N_T": N_T}, "s": s,
          "max_abs_err": err, "tol_state": TOL_STATE,
          "shapes": shape_checks, "tol_shapes": TOL_TRJ, "ms": ms,
          "forward_scan_pertraj_no_stream_ms": pertraj_ms,
          "plain_ms": plain_ms, "library_ms": library_ms,
          "launches": counts})
    return {"err": err, "ms": ms, "plain_ms": plain_ms,
            "flops": N_T * (K * (6 + s) * cmm + 8.0 * K * d * d),
            "bytes": nbytes(H0, ops, coeffs, dts, psi0, st),
            "library_ms": library_ms,
            "library_call": f"torch.linalg.matrix_exp on ({N_T * K}, {d}, "
                            f"{d}): the propagators only",
            "forward_scan_pertraj_no_stream_ms": pertraj_ms,
            "computed_by": "csrc/prop_cluster.cu + csrc/state_scan.cu "
                           "(the K5 pair, no U stream); "
                           "csrc/smalld_fused.cu for d <= 4, K >= 128"}, counts


def _tf32_chain(ar, ai, br, bi, reps):
    """The Karatsuba chain with each product's operands rounded to TF32 as
    the kernel's tensor-core path rounds them (``cvt.rna``: 10 mantissa
    bits, to nearest, ties away from zero), the products in float32: where
    the TF32 kernel's distance from the float32 chain comes from."""
    def rna(x):
        i = x.contiguous().view(torch.int32)
        return ((i + 0x1000) & -0x2000).view(torch.float32)

    cr, ci = ar, ai
    b_r, b_i, b_s = rna(br), rna(bi), rna(br + bi)
    for _ in range(reps):
        t1 = rna(cr) @ b_r
        t2 = rna(ci) @ b_i
        t3 = rna(cr + ci) @ b_s
        cr, ci = t1 - t2, t3 - t1 - t2
    return torch.complex(cr, ci)


def karatsuba_kernel_phase(dev):
    """Phases ``kernel_check_karatsuba`` (``karatsuba_chain``, K11, against
    its plain version at B = 8, reps = 16, D 100 and 128, both precisions;
    errors relative to max|c|), ``probe_mxu`` (the probe's lines at
    B = 512, reps = 256: its counted run) and ``probe_mxu_check`` (the
    kernel against its plain version on the probe's own operands, to the
    same limits).  Returns the kernel line's numbers and the counts."""
    from grape_tpu_torch.experiments import mxu_probe
    from grape_tpu_torch.ops import (
        hopper_cheby, hopper_frechet, hopper_matmul, hopper_prop,
        plain_versions,
    )

    checks = []
    err = {"highest": 0.0, "default": 0.0}
    for D in (100, 128):
        args = mxu_probe.operands(KARATSUBA_CHECK_BATCH, D, seed=SEED + D)
        for prec in ("highest", "default"):
            c = hopper_matmul.karatsuba_chain(*args, KARATSUBA_CHECK_REPS,
                                              prec)
            torch.cuda.synchronize()
            with plain_versions():
                c_p = hopper_matmul.karatsuba_chain(
                    *args, KARATSUBA_CHECK_REPS, prec)
            require(finite(c) and c.shape == (KARATSUBA_CHECK_BATCH, D, D),
                    "karatsuba_chain output is not finite or misshapen")
            e = max_abs(c, c_p) / float(c_p.abs().max())
            checks.append({"D": D, "precision": prec,
                           "max_abs_err_of_max": e,
                           "max_abs_c": float(c_p.abs().max())})
            require(e < TOL_KARATSUBA[prec],
                    f"karatsuba_chain disagrees at D={D}, {prec}: {e}")
            err[prec] = max(err[prec], e)
    emit({"phase": "kernel_check_karatsuba", "batch": KARATSUBA_CHECK_BATCH,
          "reps": KARATSUBA_CHECK_REPS, "tol_of_max": TOL_KARATSUBA,
          "checks": checks})

    # the probe: its entry point as a user runs it, every count set to 0
    zero_counts(hopper_prop, hopper_frechet, hopper_cheby, hopper_matmul)
    lines = mxu_probe.run_probe(
        B=PROBE_BATCH, reps=PROBE_REPS,
        emit=lambda obj: emit({"phase": "probe_mxu", **obj}))
    counts = read_counts(hopper_prop, hopper_frechet, hopper_cheby,
                         hopper_matmul)
    expect = dict.fromkeys(counts, 0)
    expect["karatsuba_chain"] = 2 * 2 * 3  # 2 D x 2 precisions x 3 calls
    require(counts == expect, f"probe launch counts {counts}")
    by = {ln["probe"]: ln for ln in lines}

    # the probe's launches return only a sum: hold the kernel's output on
    # the probe's own operands (``run_probe`` makes them with seed 0)
    # against its plain version, at both D and both precisions
    probe_checks = []
    for D in (100, 128):
        args = mxu_probe.operands(PROBE_BATCH, D)
        with plain_versions():
            c_p = hopper_matmul.karatsuba_chain(*args, PROBE_REPS, "highest")
            if D == 128:
                plain_ms = median_ms(lambda: hopper_matmul.karatsuba_chain(
                    *args, PROBE_REPS, "highest"), reps=1)
        scale = float(c_p.abs().max())
        c_e = _tf32_chain(*args, PROBE_REPS)
        for prec in ("highest", "default"):
            c = hopper_matmul.karatsuba_chain(*args, PROBE_REPS, prec)
            require(finite(c) and c.shape == (PROBE_BATCH, D, D),
                    "karatsuba_chain output is not finite or misshapen")
            e = max_abs(c, c_p) / scale
            probe_checks.append({"D": D, "precision": prec,
                                 "max_abs_err_of_max": e,
                                 "max_abs_c": scale,
                                 "vs_tf32_rounded_chain_of_max":
                                 max_abs(c, c_e) / scale})
            require(e < TOL_KARATSUBA[prec],
                    f"karatsuba_chain disagrees on the probe's operands at "
                    f"D={D}, {prec}: {e}")
            err[prec] = max(err[prec], e)
            del c
        del args, c_p, c_e
    emit({"phase": "probe_mxu_check", "batch": PROBE_BATCH,
          "reps": PROBE_REPS, "tol_of_max": TOL_KARATSUBA,
          "checks": probe_checks})
    D = 128
    # the least operations of the function: three real D^3 products
    real_flops = 6.0 * D ** 3 * PROBE_BATCH * PROBE_REPS
    operand_bytes = 4 * 4 * PROBE_BATCH * D * D + 8 * PROBE_BATCH * D * D
    tf32_bound = max(real_flops / PEAK_TF32_FLOPS,
                     operand_bytes / PEAK_BYTES) * 1e3
    return {"err": err["highest"], "err_tf32": err["default"],
            "ms": by[f"karatsuba_chain_kernel_d{D}_highest"]["ms"],
            "ms_tf32": by[f"karatsuba_chain_kernel_d{D}_default"]["ms"],
            "ms_d100": by["karatsuba_chain_kernel_d100_highest"]["ms"],
            "ms_d100_tf32": by["karatsuba_chain_kernel_d100_default"]["ms"],
            "plain_ms": plain_ms, "flops": real_flops,
            "bytes": operand_bytes, "bound_ms_tf32": tf32_bound,
            "library_ms": by[f"torch_c64_chain_d{D}_highest"]["ms"],
            "library_call": f"{PROBE_REPS} torch.matmul products of "
                            f"({PROBE_BATCH}, {D}, {D}) complex64",
            "shape": {"B": PROBE_BATCH, "D": D, "reps": PROBE_REPS},
            "counted_tflops": by[f"karatsuba_chain_kernel_d{D}_highest"][
                "tflops"]}, counts


# ---- recompute storage, running costs, nonlinear amplitudes, observables -

RECOMPUTE_SEGMENTS = 40
RECOMPUTE_WIDE_SAMPLES = 128
# J of the A·sin(ε) CZ in complex64 through the kernels against complex128:
# an H100 read 2.30e-5 and 2.34e-5 (the final states 1.25e-4 apart in norm;
# J_T_sm, blind to a global phase, moves less than the 2·‖Δψ(T)‖ that
# bounds it), and the control, the pulse scaled by 1 + 1e-3, 2.66e-4
TOL_J_CUSTOM_C128 = 1e-4


def _peak_bytes(fn):
    """Peak device memory allocated during ``fn()`` and its host ms."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out, torch.cuda.max_memory_allocated() - base, ms


def recompute_paths(problem, cp_full, ens_series):
    """Phases ``fg_recompute`` and ``optimize_recompute``: the robust CZ
    ensemble (K = 32 in 8 x 4, N_T = 2000) under
    ``storage_mode="recompute"`` with 40 segments of 50 steps, gradgen,
    against full storage; peak memory of each mode; one evaluation each
    way at 128 samples (K = 512); five L-BFGS-B iterations against the
    full-storage series of ``optimize_ensemble``.  Returns the counts of
    its counted run (the evaluations and the iterations)."""
    import grape_tpu_torch as gt
    from grape_tpu_torch.fg import _seg_reuse_U, _vec_gradgen_enabled
    from grape_tpu_torch.models import two_transmon_cz_ensemble_problem
    from grape_tpu_torch.ops import (
        hopper_cheby, hopper_frechet, hopper_matmul, hopper_prop,
    )

    mods = (hopper_prop, hopper_frechet, hopper_cheby, hopper_matmul)
    kw = dict(dtype=np.complex64, storage_mode="recompute",
              storage_segments=RECOMPUTE_SEGMENTS)
    cp = gt.compile_problem(problem.trajectories, problem.tlist, **kw,
                            **problem.kwargs)
    S = cp.storage_segments
    require(S == RECOMPUTE_SEGMENTS and _vec_gradgen_enabled(cp)
            and _seg_reuse_U(cp), "unexpected recompute routing")
    x0 = cp.guess_pulsevals.reshape(-1)
    fg_full = gt.build_fg(cp_full)
    (J_f, g_f, _), peak_full, _ = _peak_bytes(lambda: fg_full(x0))
    fg_full_ms = timed_ms(lambda: fg_full(x0), 2)

    zero_counts(*mods)
    fg = gt.build_fg(cp)
    J, g, aux, dJ_p, dg_p = fg_against_plain(fg, x0, "fg_recompute")
    _, peak_rec, _ = _peak_bytes(lambda: fg(x0))
    dJ = abs(float(J) - float(J_f))
    dg = max_abs(g, g_f) / float(g_f.abs().max())
    require(dJ < 1e-6 and dg < 1e-4,
            f"recompute against full storage: dJ {dJ}, dgrad {dg}")
    fg_ms = timed_ms(lambda: fg(x0), 2)
    parts = fg_breakdown(fg, x0, reps=2)
    n_fg = 1 + 1 + 2 + 3  # fg_against_plain's kernel call, the peak, the
    # timing, the breakdown (its warm call included)

    series = []
    res = gt.optimize_problem(
        problem, iter_stop=ITER_STOP, print_iters=False,
        rethrow_exceptions=True, **kw,
        callback=lambda wrk, it: series.append(float(wrk.result.J_T)))
    counts = read_counts(*mods)
    n_fg += res.fg_calls
    expect = dict.fromkeys(counts, 0)
    expect.update({"forward_scan_grouped": S * (2 * n_fg + res.f_calls),
                   "chi_scan_grouped": S * n_fg,
                   "frechet_trace_pertraj_factored": S * n_fg})
    require(counts == expect, f"recompute launch counts {counts} do not "
            f"match the evaluations {expect}")
    dseries = max(abs(a - b) for a, b in zip(series, ens_series))
    require(len(series) == len(ens_series) == ITER_STOP + 1
            and dseries < 1e-5,
            f"recompute J_T series {series} against full {ens_series}")

    # 128 samples: full storage cannot keep its propagator stream
    wide = two_transmon_cz_ensemble_problem(
        n_samples=RECOMPUTE_WIDE_SAMPLES, d=D_TRANSMON, n_steps=N_STEPS)
    wide_out = {}
    grads = {}
    for mode in ("full", "recompute"):
        extra = dict(kw) if mode == "recompute" else {"dtype": np.complex64}
        cpw = gt.compile_problem(wide.trajectories, wide.tlist, **extra,
                                 **wide.kwargs)
        xw = cpw.guess_pulsevals.reshape(-1)
        fgw = gt.build_fg(cpw)
        (Jw, gw, _), peak, ms_w = _peak_bytes(lambda: fgw(xw))
        require(math.isfinite(float(Jw)) and bool(torch.isfinite(gw).all()),
                f"K = 512 {mode}: not finite")
        grads[mode] = (float(Jw), gw)
        wide_out[mode] = {"ms": ms_w, "peak_bytes": peak, "J": float(Jw)}
        del fgw, gw
        torch.cuda.empty_cache()
    dJw = abs(grads["full"][0] - grads["recompute"][0])
    dgw = (max_abs(grads["full"][1], grads["recompute"][1])
           / float(grads["full"][1].abs().max()))
    require(dJw < 1e-6 and dgw < 1e-4,
            f"K = 512 recompute against full: dJ {dJw}, dgrad {dgw}")
    del grads
    torch.cuda.empty_cache()
    emit({"phase": "fg_recompute", "K": cp.n_traj, "segments": S,
          "segment_steps": cp.n_timesteps // S, "J": float(J),
          "J_abs_diff_vs_full": dJ, "grad_diff_of_max_vs_full": dg,
          "J_abs_diff_vs_plain": dJ_p, "grad_diff_of_max_vs_plain": dg_p,
          "ms_per_eval": fg_ms, "full_storage_ms_per_eval": fg_full_ms,
          "flop_rate": flop_rate(cp, fg_ms),
          "full_storage_flop_rate": flop_rate(cp_full, fg_full_ms),
          "device_ms_by_part": parts, "peak_bytes": peak_rec,
          "full_storage_peak_bytes": peak_full,
          "wide_128_samples": {"K": RECOMPUTE_WIDE_SAMPLES * N_BASIS,
                               **wide_out, "J_abs_diff": dJw,
                               "grad_diff_of_max": dgw}})
    emit({"phase": "optimize_recompute", "J_T_series": series,
          "full_storage_series": ens_series, "max_abs_diff": dseries,
          "iterations": res.iter, "fg_calls": res.fg_calls,
          "f_calls": res.f_calls, "message": res.message,
          "launches": counts})
    return counts


def _leakage_mask(d, dev):
    """Levels of the two-transmon register with either transmon at 2 or
    above (index i1·d + i2)."""
    i1, i2 = np.divmod(np.arange(d * d), d)
    return torch.tensor((i1 >= 2) | (i2 >= 2), device=dev)


def running_cost_gap(cz_problem, g_b, mask, x0, dev, control_rel=1e-4):
    """The limit on |ΔJ| between the kernels and the plain versions for the
    CZ with the leakage cost, from the forward states of both routes.

    ``J_b = λ_b Σ_n w_n Σ_k g_nk`` with ``g = ⟨ψ|M|ψ⟩`` and M the leakage
    projector, so states that differ by ``Δ_nk`` move it by at most
    ``λ_b Σ_n w_n Σ_k (2‖Mψ_nk‖‖Δ_nk‖ + ‖Δ_nk‖²)`` (``‖Mψ‖ = √g``); each
    float32 sum (over the levels, then over the grid and the trajectories)
    rounds by at most ``(log2 d + log2((N_T+1)·K) + 2)·2⁻²⁴`` of J_b, and
    J_T is held to 1e-5 as everywhere else.  The states' distance itself is
    held to ``TOL_STATE``.  Also: the J_b gap that the two state series
    make alone (float64 sums), which the evaluation's gap should match, and
    a control, J on the kernel route at the pulse scaled by
    ``1 + control_rel``, which the limit must tell apart.  λ_b = 1."""
    import grape_tpu_torch as gt
    from grape_tpu_torch.functionals import grid_weights
    from grape_tpu_torch.ops import plain_versions

    cpo = gt.compile_problem(
        cz_problem.trajectories, cz_problem.tlist, dtype=np.complex64,
        g_b=g_b, lambda_b=1.0, fw_prop_callback=lambda values, tlist: None,
        **cz_problem.kwargs)
    f = gt.build_f(cpo)
    J_k, aux_k = f(x0)
    with plain_versions():
        J_p, aux_p = f(x0)
    J_c, _ = f(x0 * (1.0 + control_rel))
    st_k, st_p = (a["fw_observables"][0].to(torch.complex128)
                  for a in (aux_k, aux_p))
    m = mask.to(torch.float64)
    g_k = torch.sum(st_k.abs() ** 2 * m, dim=-1)
    g_p = torch.sum(st_p.abs() ** 2 * m, dim=-1)
    e = torch.linalg.vector_norm(st_k - st_p, dim=-1)
    w = grid_weights(torch.tensor(cz_problem.tlist, dtype=torch.float64,
                                  device=dev))[:, None]
    Jb_p = float(torch.sum(w * g_p))
    n_grid, K, d = st_k.shape
    bound = float(torch.sum(w * (2 * g_p.sqrt() * e + e ** 2)))
    rounding = (2 * (math.log2(d) + math.log2(n_grid * K) + 2) * 2.0 ** -24
                * Jb_p)
    out = {"max_state_distance": float(e.max()), "J_b_plain": Jb_p,
           "J_b_gap_of_the_states": abs(float(torch.sum(w * (g_k - g_p)))),
           "J_gap_build_f": abs(float(J_k) - float(J_p)),
           "J_b_bound_from_states": bound, "rounding_bound": rounding,
           "tol_J": 1e-5 + bound + rounding, "control_rel": control_rel,
           "control_J_abs_diff": abs(float(J_c) - float(J_k))}
    require(out["max_state_distance"] < TOL_STATE,
            f"leakage CZ: kernel states differ by {out['max_state_distance']}")
    return out


def running_cost_paths(cz_problem, dev):
    """Phase ``fg_running_cost``: BASELINE config 3 (the qutrit X gate
    with its guard-level cost: d = 3, K = 2, N_T = 400) — J_b, ξ analytic
    against ``make_xi``, complex64 against complex128, five iterations —
    and the CZ at dim 100 with the leakage population of either transmon as
    ``g_b`` (ξ by ``make_xi``): kernels against plain, the time with the ξ
    chain's share.  Returns the counts of the CZ run and of config 3's one
    evaluation."""
    import grape_tpu_torch as gt
    from grape_tpu_torch.functionals import make_xi
    from grape_tpu_torch.models import transmon_qutrit_problem
    from grape_tpu_torch.ops import (
        hopper_cheby, hopper_frechet, hopper_matmul, hopper_prop,
    )

    mods = (hopper_prop, hopper_frechet, hopper_cheby, hopper_matmul)
    q = transmon_qutrit_problem()
    cps = {dt: gt.compile_problem(q.trajectories, q.tlist, dtype=dt,
                                  **q.kwargs)
           for dt in (np.complex64, np.complex128)}
    xq = cps[np.complex64].guess_pulsevals.reshape(-1)
    # config 3's one evaluation is the counted run of the dense Frechet
    # kernel under one shared generator: at d = 3 it needs fewer operations
    # than the factored one
    zero_counts(*mods)
    fg_q = gt.build_fg(cps[np.complex64])
    J64, g64, aux64 = fg_q(xq)
    counts_q = read_counts(*mods)
    expect_q = dict.fromkeys(counts_q, 0)
    expect_q.update({"forward_scan_shared": 1, "frechet_trace_shared": 1})
    require(counts_q == expect_q, f"config 3 launch counts {counts_q}")
    J128, g128, aux128 = gt.build_fg(cps[np.complex128])(xq)
    Jb = float(aux64["J_parts"][2])
    require(Jb > 0 and finite(g64.to(torch.complex64)),
            f"config 3: J_b {Jb}")
    dJq = abs(float(J64) - float(J128))
    dgq = float((g64.double() - g128).abs().max() / g128.abs().max())
    require(dJq < 1e-5 and dgq < 1e-3,
            f"config 3 complex64 against complex128: dJ {dJq}, dg {dgq}")
    fg_q_ms = timed_ms(lambda: fg_q(xq), 3)
    parts_q = fg_breakdown(fg_q, xq)
    rng = np.random.default_rng(SEED + 3)
    P = torch.tensor(rng.normal(size=(2, 3)) + 1j * rng.normal(size=(2, 3)),
                     dtype=torch.complex64, device=dev)
    tl = torch.tensor(q.tlist, dtype=torch.float32, device=dev)
    xi_auto = make_xi(q.kwargs["g_b"], q.trajectories)(P, None, tl, 5)
    dxi = max_abs(xi_auto, q.kwargs["xi"](P, None, tl, 5))
    require(dxi < 1e-6, f"config 3: make_xi against analytic xi {dxi}")
    series = []
    res = gt.optimize_problem(
        q, iter_stop=ITER_STOP, dtype=np.complex64, print_iters=False,
        rethrow_exceptions=True,
        callback=lambda wrk, it: series.append(
            float(wrk.J_parts[0] + wrk.J_parts[2])))
    require(len(series) == ITER_STOP + 1
            and all(b < a for a, b in zip(series, series[1:])),
            f"config 3: J does not fall monotonically: {series}")

    # the CZ at dim 100 with a leakage running cost
    mask = _leakage_mask(D_TRANSMON, dev)

    def g_b(Psi, trajectories, tlist, n):
        return torch.sum(torch.abs(Psi) ** 2 * mask, dim=-1)

    kw = dict(cz_problem.kwargs)
    cpl = gt.compile_problem(cz_problem.trajectories, cz_problem.tlist,
                             dtype=np.complex64, g_b=g_b, lambda_b=1.0, **kw)
    x0 = cpl.guess_pulsevals.reshape(-1)
    gap = running_cost_gap(cz_problem, g_b, mask, x0, dev)
    zero_counts(*mods)
    fg = gt.build_fg(cpl)
    J, g, aux, dJ, dg = fg_against_plain(fg, x0, "fg_running_cost",
                                         tol_J=gap["tol_J"])
    require(gap["control_J_abs_diff"] > gap["tol_J"],
            f"the J limit {gap['tol_J']} does not tell the control apart")
    require(abs(dJ - gap["J_b_gap_of_the_states"])
            < 1e-5 + gap["rounding_bound"],
            f"fg_running_cost: the J gap {dJ} is not the forward states' "
            f"{gap['J_b_gap_of_the_states']}")
    Jb_cz = float(aux["J_parts"][2])
    require(Jb_cz > 0, f"CZ leakage cost J_b {Jb_cz}")
    fg_ms = timed_ms(lambda: fg(x0), 3)
    parts = fg_breakdown(fg, x0)
    counts = read_counts(*mods)
    n_fg = 1 + 3 + 4
    expect = dict.fromkeys(counts, 0)
    expect.update({"forward_scan_shared": n_fg,
                   "frechet_trace_shared_factored": n_fg})
    require(counts == expect, f"running-cost launch counts {counts}")
    emit({"phase": "fg_running_cost",
          "config3": {"J": float(J64), "J_b_times_lambda": Jb,
                      "J_complex128": float(J128), "J_abs_diff": dJq,
                      "grad_diff_of_max": dgq, "xi_make_xi_vs_analytic": dxi,
                      "J_series": series, "iterations": res.iter,
                      "ms_per_eval": fg_q_ms,
                      "flop_rate": flop_rate(cps[np.complex64], fg_q_ms),
                      "device_ms_by_part": parts_q,
                      "launches_one_eval": counts_q},
          "cz_leakage": {"J": float(J), "J_b_times_lambda": Jb_cz,
                         "J_abs_diff_vs_plain": dJ,
                         "grad_diff_of_max_vs_plain": dg,
                         "ms_per_eval": fg_ms,
                         "flop_rate": flop_rate(cpl, fg_ms),
                         "device_ms_by_part": parts,
                         "xi_chain_ms": parts.get("chi_window_plain", 0.0)
                         + parts.get("_xi_sources", 0.0),
                         "J_limit": gap, "launches": counts}})
    return counts, counts_q


def custom_amplitude_path(cz_problem):
    """Phase ``fg_custom_amplitude``: the CZ at dim 100 with its four
    drives as ``CustomAmplitude(lambda v, t: A·sin(v[0]), control)`` and an
    analytic bound; K1–K3 once per evaluation, kernels against plain, and
    complex64 against complex128 on the card.  Returns the counts."""
    import grape_tpu_torch as gt
    from grape_tpu_torch.ops import (
        hopper_cheby, hopper_frechet, hopper_matmul, hopper_prop,
    )

    mods = (hopper_prop, hopper_frechet, hopper_cheby, hopper_matmul)
    A = 1.0
    gen = cz_problem.trajectories[0].generator
    terms = [
        (op, gt.CustomAmplitude(
            lambda v, t: A * torch.sin(v[0]), ctl,
            bound=lambda amp_max: (A, np.asarray([A]))))
        for op, ctl in gen.terms
    ]
    H = gt.hamiltonian(gen.drift, *terms)
    trajs = [gt.Trajectory(t.initial_state, H, target_state=t.target_state)
             for t in cz_problem.trajectories]
    kw = dict(cz_problem.kwargs)
    cps = {dt: gt.compile_problem(trajs, cz_problem.tlist, dtype=dt, **kw)
           for dt in (np.complex64, np.complex128)}
    cp = cps[np.complex64]
    require(len(cp.custom_terms) == 4 and cp.shared_generator,
            "the custom-amplitude CZ must have four nonlinear slots")
    x0 = cp.guess_pulsevals.reshape(-1)
    zero_counts(*mods)
    fg = gt.build_fg(cp)
    J, g, aux, dJ, dg = fg_against_plain(fg, x0, "fg_custom_amplitude")
    fg_ms = timed_ms(lambda: fg(x0), 3)
    counts = read_counts(*mods)
    expect = dict.fromkeys(counts, 0)
    expect.update({"forward_scan_shared": 4, "chi_scan_shared": 4,
                   "frechet_trace_shared_factored": 4})
    require(counts == expect, f"custom-amplitude launch counts {counts}")
    fg128 = gt.build_fg(cps[np.complex128])
    J128, g128, aux128 = fg128(x0)
    dJ128 = abs(float(J) - float(J128))
    dg128 = float((g.double() - g128).abs().max() / g128.abs().max())
    # the final states' distance from complex128, and a control: complex128
    # J at the pulse scaled by 1 + 1e-3, which the limit must tell apart
    e_T = float(torch.linalg.vector_norm(
        aux["psi_T"].to(torch.complex128) - aux128["psi_T"], dim=-1).max())
    J128_c, _, _ = fg128(x0 * (1.0 + 1e-3))
    control = abs(float(J128_c) - float(J128))
    require(dg128 < 1e-3 and dJ128 < TOL_J_CUSTOM_C128
            and control > TOL_J_CUSTOM_C128,
            f"custom amplitude complex64 against complex128: dJ {dJ128} "
            f"(limit {TOL_J_CUSTOM_C128}, control {control}), dgrad {dg128}")
    emit({"phase": "fg_custom_amplitude", "J": float(J),
          "grad_norm": float(g.norm()), "ms_per_eval": fg_ms,
          "flop_rate": flop_rate(cp, fg_ms),
          "J_abs_diff_vs_plain": dJ, "grad_diff_of_max_vs_plain": dg,
          "J_complex128": float(J128), "J_abs_diff_vs_complex128": dJ128,
          "final_state_distance_vs_complex128": e_T,
          "J_limit_vs_complex128": TOL_J_CUSTOM_C128,
          "control_J_abs_diff_pulse_1e-3": control,
          "grad_diff_of_max_vs_complex128": dg128, "launches": counts})
    return counts


def observables_path(cz_problem, dev):
    """Phase ``fg_observables``: the CZ with ``fw_prop_callback`` and two
    observables (the population of the computational levels and of the
    leakage levels, per trajectory) over one L-BFGS-B iteration; the
    callback is called once per evaluation with ``(N_T+1, K)`` values,
    which equal the observables of the states themselves.  Returns the
    counts."""
    import grape_tpu_torch as gt
    from grape_tpu_torch.ops import (
        hopper_cheby, hopper_frechet, hopper_matmul, hopper_prop,
    )

    mods = (hopper_prop, hopper_frechet, hopper_cheby, hopper_matmul)
    leak = _leakage_mask(D_TRANSMON, dev)
    comp = torch.zeros_like(leak)
    comp[[0, 1, D_TRANSMON, D_TRANSMON + 1]] = True

    def pop_comp(Psi, tlist, n):
        return torch.sum(torch.abs(Psi) ** 2 * comp, dim=-1)

    def pop_leak(Psi, tlist, n):
        return torch.sum(torch.abs(Psi) ** 2 * leak, dim=-1)

    seen = []
    zero_counts(*mods)
    res = gt.optimize_problem(
        cz_problem, iter_stop=1, dtype=np.complex64, print_iters=False,
        rethrow_exceptions=True,
        fw_prop_callback=lambda values, tlist: seen.append(values),
        fw_prop_observables=[pop_comp, pop_leak])
    counts = read_counts(*mods)
    n_eval = res.fg_calls + res.f_calls
    N_T, K = N_STEPS, len(cz_problem.trajectories)
    require(len(seen) == n_eval,
            f"callback called {len(seen)} times for {n_eval} evaluations")
    require(all(len(v) == 2 and v[0].shape == (N_T + 1, K)
                and v[1].shape == (N_T + 1, K) for v in seen),
            "observables have the wrong shapes")
    first = seen[0]
    total = np.abs(first[0]) + np.abs(first[1])
    require(np.all(np.isfinite(total)) and float(total.max()) < 1 + 1e-4
            and abs(float(first[0][0].real.min()) - 1.0) < 1e-6,
            "observable values are not populations")
    # the same evaluation with the states themselves (no observables)
    states = []
    cp = gt.compile_problem(cz_problem.trajectories, cz_problem.tlist,
                            dtype=np.complex64,
                            fw_prop_callback=lambda v, t: None,
                            **cz_problem.kwargs)
    _, _, aux = gt.build_fg(cp)(cp.guess_pulsevals.reshape(-1))
    st = aux["fw_observables"][0]
    require(st.shape == (N_T + 1, K, D_TRANSMON ** 2), "states' shape")
    want = torch.sum(torch.abs(st) ** 2 * leak, dim=-1).cpu().numpy()
    dobs = float(np.max(np.abs(first[1].real - want)))
    require(dobs < 1e-6, f"observable against the states: {dobs}")
    expect = dict.fromkeys(counts, 0)
    expect.update({"forward_scan_shared": n_eval,
                   "chi_scan_shared": res.fg_calls,
                   "frechet_trace_shared_factored": res.fg_calls})
    require(counts == expect, f"observables launch counts {counts}")
    emit({"phase": "fg_observables", "callback_calls": len(seen),
          "evaluations": n_eval, "shapes": [list(v.shape) for v in first],
          "leakage_max": float(np.abs(first[1]).max()),
          "observable_vs_states_max_abs": dobs, "launches": counts})
    return counts


# ---- this slice: the host modules and the kernels' non-Hermitian inputs ---

# the CPU's complex64 runs of the golden problems (the kernels' plain
# versions) deviate from the complex128 golden series by at most these
# shares of each entry (tests/golden/traces.json; PERF.md section 6): the
# card's limit is ten times that, fixed before the card's first run
GOLDEN_CPU_C64_REL_DEV = {
    "lindblad_tls": 0.027898336473076345,
    "stirap_running_cost": 0.06798927557215392,
    "dummy_seeded": 0.05251003609558167,
    "subspace_gate": 7.640763286407417e-06,
}
GOLDEN_CARD_FACTOR = 10.0
# the open-system CZ: decay rate of each transmon's ladder operator
OPEN_CZ_GAMMA = 0.01


def flop_rate(cp, ms):
    """``fg_flops`` of one evaluation of ``cp`` (``grape_tpu_torch.flops``:
    the algorithmic work, whatever implements it) and the rate it implies
    at ``ms`` per evaluation."""
    from grape_tpu_torch.flops import fg_flops

    flops = fg_flops(cp)
    return {"fg_flops": flops, "tflops_per_s": flops / (ms * 1e-3) / 1e12}


def golden_check(name, series, res):
    """The card's complex64 J_T series against the complex128 golden one:
    the largest relative deviation, held to ten times the CPU complex64
    run's; the iteration count and ``converged`` beside the golden ones."""
    with open(os.path.join(HERE, "tests", "golden", "traces.json")) as fh:
        ref = json.load(fh)[name]
    n = min(len(series), len(ref["J_T_trace"]))
    rel = np.abs(np.asarray(series[:n]) - ref["J_T_trace"][:n]) / np.abs(
        ref["J_T_trace"][:n])
    limit = GOLDEN_CARD_FACTOR * GOLDEN_CPU_C64_REL_DEV[name]
    out = {"max_rel_dev": float(rel.max()), "limit": limit,
           "cpu_complex64_max_rel_dev": GOLDEN_CPU_C64_REL_DEV[name],
           "iter": res.iter, "golden_iter": ref["iter"],
           "converged": bool(res.converged),
           "golden_converged": ref["converged"], "message": res.message,
           "golden_message": ref["message"]}
    require(all(math.isfinite(v) for v in series),
            f"{name}: J_T series not finite: {series}")
    require(out["max_rel_dev"] < limit,
            f"{name}: J_T series deviates from the golden one: {out}")
    return out


def _lindblad_cz_generators(d, n_steps, gammas, detunings):
    """Liouvillians of ``two_transmon_cz_problem(d)``'s generator, one per
    (decay rate, detuning of the second transmon), with the decay of both
    transmons' ladder operators (dim d⁴): ``(problem, [Generator])``."""
    import grape_tpu_torch as gt
    from grape_tpu_torch.models import two_transmon_cz_problem

    a = np.diag(np.sqrt(np.arange(1, d)), 1).astype(complex)
    eye = np.eye(d, dtype=complex)
    gens = []
    for gamma, delta2 in zip(gammas, detunings):
        p = two_transmon_cz_problem(d=d, n_steps=n_steps, delta2=delta2)
        c_ops = [np.sqrt(gamma) * np.kron(a, eye),
                 np.sqrt(gamma) * np.kron(eye, a)]
        gens.append(gt.liouvillian(p.trajectories[0].generator, c_ops))
    return p, gens


def open_cz_problem(n_steps=N_STEPS, **kwargs):
    """The CZ gate at d = 3 as an open system: its Liouvillian (dim 81)
    with decay rate ``OPEN_CZ_GAMMA`` on both transmons, four vectorized
    density matrices (two logical populations, two coherences) toward their
    images under CZ, ``J_T_re``."""
    import grape_tpu_torch as gt
    from grape_tpu_torch.functionals import J_T_re

    d = 3
    p, (L,) = _lindblad_cz_generators(d, n_steps, [OPEN_CZ_GAMMA], [0.5])
    dim = d * d

    def ket(i, j):
        v = np.zeros(dim, dtype=complex)
        v[i * d + j] = 1.0
        return v

    def vec(rho):
        return np.asarray(rho).T.reshape(-1)

    cz = np.ones(dim, dtype=complex)
    cz[1 * d + 1] = -1.0
    pairs = [(ket(0, 0), ket(0, 0)), (ket(1, 1), ket(1, 1)),
             (ket(0, 0), ket(1, 1)), (ket(0, 1), ket(1, 0))]
    trajs = []
    for u, v in pairs:
        rho = np.outer(u, v.conj())
        target = (cz[:, None] * rho) * cz.conj()[None, :]
        trajs.append(gt.Trajectory(vec(rho), L, target_state=vec(target)))
    kwargs.setdefault("J_T", J_T_re)
    return gt.ControlProblem(trajs, p.tlist, **kwargs)


def nonhermitian_kernel_phase(rng, dev):
    """Phase ``nonhermitian_kernels``: every kernel of the paths that take
    Liouvillians, launched on seeded non-Hermitian, non-normal generators
    and held against its plain version on the card: the dissipative TLS
    (dim 4) and the open CZ (dim 81, N_T = 2000) under K1, K2 and both
    Fréchet kernels forced; eight groups of four and 32 distinct dim-81
    Liouvillians under K4, K5 (with and without the U stream), the grouped
    and re-formed χ chains, K6 (both kernels) and K10; 128 dissipative TLSs
    with spread decay rates under K7 (with and without U) and K10's small-d
    route.  The limits are the Hermitian checks' (``TOL_STATE`` for the
    propagators and the co-state chains over given propagators,
    ``TOL_TRJ`` of the scale for the traces, ``TOL_ROUTES`` between the
    two Fréchet kernels), each relative to max(1, the scale of the plain
    result), except the state chains: a chain of 2000 non-unitary float32
    steps drifts from the exact one by more than a unitary chain does, so
    the kernel's chain is held to the larger of ``TOL_STATE`` and twice the
    plain float32 chain's own distance from a complex128 chain on the same
    inputs (two float32 evaluations, each that far from the exact one).
    The phase line is printed before a failed limit raises.  The route
    counts show which kernels the inputs took."""
    import grape_tpu_torch as gt
    from grape_tpu_torch.fg import _static_squarings
    from grape_tpu_torch.models import dissipative_tls_problem
    from grape_tpu_torch.ops import hopper_cheby, hopper_frechet as hf
    from grape_tpu_torch.ops import hopper_prop as hp, plain_versions

    c64 = lambda x: torch.tensor(np.ascontiguousarray(x),
                                 dtype=torch.complex64, device=dev)
    f32 = lambda x: torch.tensor(np.ascontiguousarray(x),
                                 dtype=torch.float32, device=dev)
    c128 = lambda x: x.to(torch.complex128 if x.is_complex()
                          else torch.float64)

    def unit(K, d):
        v = rng.normal(size=(K, d)) + 1j * rng.normal(size=(K, d))
        return c64(v / np.linalg.norm(v, axis=1, keepdims=True))

    def coeff_table(cp):
        L, N_T = cp.n_controls, cp.n_timesteps
        eps = cp.guess_pulsevals + 0.02 * rng.normal(size=(L, N_T))
        return f32(np.einsum("ntl,ln->nt", cp.M, eps) + cp.Mfix)

    def rel(a, b):
        return max_abs(a, b) / max(float(b.abs().max()), 1.0)

    def state_limit(H0, ops, co, dts, psi0, gs, s, st_p):
        """``TOL_STATE`` or twice the plain chain's distance from the
        complex128 chain (``st_p`` the plain float32 states)."""
        st_x, _ = hp.forward_scan_grouped_plain(
            c128(H0), c128(ops), c128(co), c128(dts), c128(psi0), gs, s,
            with_propagators=False)
        drift = rel(st_p.to(torch.complex128), st_x)
        return max(TOL_STATE, 2 * drift), drift

    zero_counts(hp, hf, hopper_cheby)
    rows, failed = [], []

    def check(name, errs, limits, **info):
        rows.append({"case": name, **info, **errs,
                     "limits": {k: limits[k] for k in errs}})
        for key, val in errs.items():
            if not (math.isfinite(val) and val < limits[key]):
                failed.append(f"{name}: {key} {val} (limit {limits[key]})")

    lim = {"U": TOL_STATE, "chi": TOL_STATE, "chi_recompute": TOL_STATE,
           "trj_dense": TOL_TRJ, "trj_factored": TOL_TRJ,
           "factored_vs_dense": TOL_ROUTES}

    # ---- one shared Liouvillian: K1, K2, K3 --------------------------------
    shared = {
        "dissipative_tls_d4": dissipative_tls_problem(gamma=0.05,
                                                      n_steps=200),
        "open_cz_d81": open_cz_problem(),
    }
    for case, problem in shared.items():
        cp = gt.compile_problem(problem.trajectories, problem.tlist,
                                dtype=np.complex64, **problem.kwargs)
        H0, ops = c64(cp.H0[0]), c64(cp.ops[0])
        A = cp.H0[0]
        require(np.abs(A - A.conj().T).max() > 1e-3 and np.abs(
            A @ A.conj().T - A.conj().T @ A).max() > 1e-6,
            f"{case}: the generator must be neither Hermitian nor normal")
        co, dts = coeff_table(cp), f32(np.diff(cp.tlist))
        K, d, T = cp.n_traj, cp.dim, cp.ops.shape[1]
        psi0, chi0 = c64(cp.psi0), unit(K, d)
        for s in sorted({_static_squarings(cp), 2}):
            st, U = hp.forward_scan_shared(H0, ops, co, dts, psi0, s)
            chis = hp.chi_scan_shared(U, chi0)
            psis = st[:-1].contiguous()
            trj = {r: frechet_forced(r, H0, ops, co, dts, psis, chis, s)
                   for r in ("dense", "factored")}
            torch.cuda.synchronize()
            with plain_versions():
                st_p, U_p = hp.forward_scan_shared(H0, ops, co, dts, psi0, s)
                chis_p = hp.chi_scan_shared(U, chi0)
                trj_p = {r: frechet_forced(r, H0, ops, co, dts, psis, chis,
                                           s) for r in trj}
            require(finite(st, U, chis, *trj.values()),
                    f"{case}: a kernel output is not finite")
            lim["states"], drift = state_limit(H0[None], ops[None], co, dts,
                                               psi0, K, s, st_p)
            check(f"{case}_s{s}", {
                "states": rel(st, st_p), "U": rel(U, U_p),
                "chi": rel(chis, chis_p),
                "trj_dense": rel(trj["dense"], trj_p["dense"]),
                "trj_factored": rel(trj["factored"], trj_p["factored"]),
                "factored_vs_dense": rel(trj["factored"], trj_p["dense"]),
            }, lim, d=d, K=K, T=T, N_T=cp.n_timesteps, s=s,
                frechet_route=hf.frechet_route(d, T, K, s),
                plain_states_vs_complex128=drift)
        del st, U, st_p, U_p

    # ---- stacks of dim-81 Liouvillians: K4, K5, K6, K10 --------------------
    G, gs = N_SAMPLES, N_BASIS
    p_open = open_cz_problem()
    cp_open = gt.compile_problem(p_open.trajectories, p_open.tlist,
                                 dtype=np.complex64, **p_open.kwargs)
    s_open = _static_squarings(cp_open)
    co, dts = coeff_table(cp_open), f32(np.diff(cp_open.tlist))
    N_T, d = cp_open.n_timesteps, cp_open.dim

    def stack(n):
        gammas = OPEN_CZ_GAMMA * np.linspace(0.5, 2.0, n)
        _, gens = _lindblad_cz_generators(3, N_T, gammas,
                                          0.5 + 0.01 * np.arange(n))
        return (c64(np.stack([g.drift for g in gens])),
                c64(np.stack([np.stack([op for op, _ in g.terms])
                              for g in gens])))

    H0g, opsg = stack(G)
    psi0 = c64(np.tile(cp_open.psi0, (G, 1)))
    chi0 = unit(G * gs, d)
    st, U = hp.forward_scan_grouped(H0g, opsg, co, dts, psi0, gs, s_open)
    chis = hp.chi_scan_grouped(U, chi0)
    psis = st[:-1].contiguous()
    trj = {r: frechet_forced(r, H0g, opsg, co, dts, psis, chis, s_open)
           for r in ("dense", "factored")}
    torch.cuda.synchronize()
    with plain_versions():
        st_p, U_p = hp.forward_scan_grouped(H0g, opsg, co, dts, psi0, gs,
                                            s_open)
        chis_p = hp.chi_scan_grouped(U, chi0)
        trj_p = {r: frechet_forced(r, H0g, opsg, co, dts, psis, chis,
                                   s_open) for r in trj}
    require(finite(st, U, chis, *trj.values()),
            "grouped Liouvillians: a kernel output is not finite")
    lim["states"], drift = state_limit(H0g, opsg, co, dts, psi0, gs, s_open,
                                       st_p)
    check("grouped_8x4_d81", {
        "states": rel(st, st_p), "U": rel(U, U_p), "chi": rel(chis, chis_p),
        "trj_dense": rel(trj["dense"], trj_p["dense"]),
        "trj_factored": rel(trj["factored"], trj_p["factored"]),
        "factored_vs_dense": rel(trj["factored"], trj_p["dense"]),
    }, lim, d=d, G=G, gs=gs, N_T=N_T, s=s_open,
        frechet_route=hf.frechet_route(d, opsg.shape[1], gs, s_open),
        plain_states_vs_complex128=drift)
    del st, U, st_p, U_p

    K = G * gs
    H0k, opsk = stack(K)
    chi0 = unit(K, d)
    st, U = hp.forward_scan_pertraj(H0k, opsk, co, dts, psi0, s_open)
    st_w, _ = hp.forward_scan_pertraj(H0k, opsk, co, dts, psi0, s_open,
                                      with_propagators=False)
    st_t = hp.forward_scan_time(H0k, opsk, co, dts, psi0, s_open)
    chis = hp.chi_scan_grouped(U, chi0)
    chis_r, _ = hp.chi_scan_recompute(H0k, opsk, co, dts, chi0, s_open)
    psis = st[:-1].contiguous()
    trj = {r: frechet_forced(r, H0k, opsk, co, dts, psis, chis, s_open)
           for r in ("dense", "factored")}
    torch.cuda.synchronize()
    with plain_versions():
        st_p, U_p = hp.forward_scan_pertraj(H0k, opsk, co, dts, psi0,
                                            s_open)
        chis_p = hp.chi_scan_grouped(U, chi0)
        trj_p = {r: frechet_forced(r, H0k, opsk, co, dts, psis, chis,
                                   s_open) for r in trj}
    require(finite(st, U, st_w, st_t, chis, chis_r, *trj.values()),
            "per-trajectory Liouvillians: a kernel output is not finite")
    del U_p
    lim["states"], drift = state_limit(H0k, opsk, co, dts, psi0, 1, s_open,
                                       st_p)
    lim["states_no_U"] = lim["time"] = lim["states"]
    check("pertraj_32_d81", {
        "states": rel(st, st_p), "states_no_U": rel(st_w, st_p),
        "time": rel(st_t, st_p), "chi": rel(chis, chis_p),
        "chi_recompute": rel(chis_r, chis_p),
        "trj_dense": rel(trj["dense"], trj_p["dense"]),
        "trj_factored": rel(trj["factored"], trj_p["factored"]),
        "factored_vs_dense": rel(trj["factored"], trj_p["dense"]),
    }, lim, d=d, K=K, gs=1, N_T=N_T, s=s_open,
        frechet_route=hf.frechet_route(d, opsk.shape[1], 1, s_open),
        plain_states_vs_complex128=drift)
    del st, U, st_w, st_t, st_p, chis_r, trj, trj_p
    torch.cuda.empty_cache()

    # ---- 128 dissipative TLSs: K7 and K10's small-d route ------------------
    n_tls = 128
    tls = [dissipative_tls_problem(gamma=g, n_steps=QUTRIT_STEPS)
           for g in np.linspace(0.01, 0.2, n_tls)]
    cp_t = gt.compile_problem(tls[0].trajectories, tls[0].tlist,
                              dtype=np.complex64, **tls[0].kwargs)
    H0t = c64(np.stack([p.trajectories[0].generator.drift for p in tls]))
    opst = c64(np.stack([np.stack([op for op, _ in
                                   p.trajectories[0].generator.terms])
                         for p in tls]))
    co_t, dts_t = coeff_table(cp_t), f32(np.diff(cp_t.tlist))
    psi0_t = c64(np.tile(cp_t.psi0, (n_tls, 1)))
    for s in sorted({_static_squarings(cp_t), 2}):
        st, U = hp.forward_scan_smalld(H0t, opst, co_t, dts_t, psi0_t, s,
                                       with_propagators=True)
        st_w = hp.forward_scan_smalld(H0t, opst, co_t, dts_t, psi0_t, s)
        st_t = hp.forward_scan_time(H0t, opst, co_t, dts_t, psi0_t, s)
        torch.cuda.synchronize()
        with plain_versions():
            st_p, U_p = hp.forward_scan_smalld(H0t, opst, co_t, dts_t,
                                               psi0_t, s,
                                               with_propagators=True)
        require(finite(st, U, st_w, st_t),
                "128 dissipative TLSs: a kernel output is not finite")
        lim["states"], drift = state_limit(H0t, opst, co_t, dts_t, psi0_t, 1,
                                           s, st_p)
        lim["states_no_U"] = lim["time"] = lim["states"]
        check(f"smalld_128_tls_d4_s{s}", {
            "states": rel(st, st_p), "U": rel(U, U_p),
            "states_no_U": rel(st_w, st_p), "time": rel(st_t, st_p),
        }, lim, d=4, K=n_tls, N_T=cp_t.n_timesteps, s=s,
            plain_states_vs_complex128=drift)

    counts = read_counts(hp, hf, hopper_cheby)
    routes = ROUTE_READS[-1][1]
    emit({"phase": "nonhermitian_kernels", "tol_state": TOL_STATE,
          "tol_trj_of_scale": TOL_TRJ, "tol_routes_of_scale": TOL_ROUTES,
          "limits_relative_to": "max(1, max|plain result|)",
          "checks": rows, "failed": failed, "launches": counts,
          "route_launches": routes})
    require(not failed, f"non-Hermitian kernels against their plain "
            f"versions: {failed}")
    for key in ("forward_scan_shared", "chi_scan_shared",
                "frechet_trace_shared", "frechet_trace_shared_factored",
                "forward_scan_grouped", "forward_scan_pertraj",
                "chi_scan_grouped", "chi_scan_recompute",
                "frechet_trace_pertraj", "frechet_trace_pertraj_factored",
                "forward_scan_smalld", "forward_scan_time"):
        require(counts.get(key, 0) >= 1,
                f"non-Hermitian phase: {key} was never launched")
    for key in ("propagators_cluster", "state_scan_forward",
                "state_scan_chi", "smalld_fused"):
        require(routes.get(key, 0) >= 1,
                f"non-Hermitian phase: route {key} was never taken")
    return cp_open


def open_system_paths(cp_open, dev):
    """Phase ``open_system``: the dissipative TLS (``gamma=0.05``,
    200 steps) optimized for 15 iterations on the card through the kernels,
    its fg at the guess held against the plain versions and its J_T series
    against the golden ``lindblad_tls`` one; the open CZ (dim 81) for one
    fg evaluation against the plain versions (J to a limit derived from the
    complex128 J), timed."""
    import grape_tpu_torch as gt
    from grape_tpu_torch.models import dissipative_tls_problem
    from grape_tpu_torch.ops import (
        hopper_cheby, hopper_frechet, hopper_prop, plain_versions,
    )

    problem = dissipative_tls_problem(gamma=0.05, n_steps=200, iter_stop=15)
    cp = gt.compile_problem(problem.trajectories, problem.tlist,
                            dtype=np.complex64,
                            **{k: v for k, v in problem.kwargs.items()
                               if k != "iter_stop"})
    x0 = cp.guess_pulsevals.reshape(-1)
    J, _, _, dJ, dg = fg_against_plain(gt.build_fg(cp), x0, "open TLS")
    series = []
    zero_counts(hopper_prop, hopper_frechet, hopper_cheby)
    res = gt.optimize_problem(
        problem, dtype=np.complex64, print_iters=False,
        rethrow_exceptions=True,
        callback=lambda wrk, it: series.append(float(wrk.result.J_T)))
    torch.cuda.synchronize()
    counts = read_counts(hopper_prop, hopper_frechet, hopper_cheby)
    n_fg, n_f = res.fg_calls, res.f_calls
    frechet = ("frechet_trace_shared_factored"
               if counts.get("frechet_trace_shared_factored")
               else "frechet_trace_shared")
    require(counts["forward_scan_shared"] == n_fg + n_f
            and counts["chi_scan_shared"] == n_fg
            and counts[frechet] == n_fg,
            f"open TLS launch counts {counts} do not match the evaluations "
            f"({n_fg} fg, {n_f} f)")
    golden = golden_check("lindblad_tls", series, res)
    require(res.iter == golden["golden_iter"] and res.J_T < 0.1,
            f"open TLS: {res.iter} iterations, J_T {res.J_T}")

    # the open CZ at dim 81: one evaluation, kernels against plain, timed.
    # Its J comes from 2000 non-unitary float32 steps, whose chain drifts
    # from the exact one more than the unitary CZ's: J is held to the
    # larger of 1e-5 and twice the plain float32 J's distance from the
    # complex128 J (two float32 evaluations, each that far from it)
    fg81 = gt.build_fg(cp_open)
    x81 = cp_open.guess_pulsevals.reshape(-1)
    with plain_versions():
        J81_p = float(fg81(x81)[0])
    p_open = open_cz_problem()
    cp128 = gt.compile_problem(p_open.trajectories, p_open.tlist,
                               dtype=np.complex128, **p_open.kwargs)
    J81_128 = float(gt.build_fg(cp128)(x81)[0])
    del cp128
    tol_J81 = max(1e-5, 2 * abs(J81_p - J81_128))
    zero_counts(hopper_prop, hopper_frechet, hopper_cheby)
    J81, g81, _, dJ81, dg81 = fg_against_plain(fg81, x81, "open CZ",
                                               tol_J=tol_J81)
    counts81 = read_counts(hopper_prop, hopper_frechet, hopper_cheby)
    require(counts81["forward_scan_shared"] == 1
            and counts81["chi_scan_shared"] == 1,
            f"open CZ launch counts {counts81}")
    ms81 = timed_ms(lambda: fg81(x81), 5)
    parts81 = fg_breakdown(fg81, x81)
    emit({"phase": "open_system",
          "tls": {"dim": cp.dim, "N_T": cp.n_timesteps, "J": float(J),
                  "J_abs_diff_vs_plain": dJ, "grad_diff_of_max_vs_plain": dg,
                  "J_T_series": series, "golden": golden,
                  "fg_calls": n_fg, "f_calls": n_f, "launches": counts},
          "cz_d81": {"dim": cp_open.dim, "K": cp_open.n_traj,
                     "N_T": cp_open.n_timesteps, "gamma": OPEN_CZ_GAMMA,
                     "J": float(J81), "J_abs_diff_vs_plain": dJ81,
                     "J_limit": tol_J81, "J_complex128": J81_128,
                     "J_plain_abs_diff_vs_complex128": abs(J81_p - J81_128),
                     "grad_diff_of_max_vs_plain": dg81,
                     "ms_per_eval": ms81, "device_ms_by_part": parts81,
                     "flop_rate": flop_rate(cp_open, ms81),
                     "launches_one_eval": counts81}})


def host_module_paths(cz_problem, dev):
    """Phase ``host_modules``: on the card through the kernels, the X-gate
    (BASELINE config 2; its global phase checked by ``propagate``), the
    STIRAP running-cost problem, the seeded dummy problem (to J_T < 1e-5)
    and the subspace gate, each J_T series against its golden one where
    there is one; then ``optimize_or_load`` on the CZ at dim 100 (written,
    reloaded without a launch, resumed as ``continue_from``), and
    ``propagate`` of its optimized pulse against the evaluation's own
    final states, forward and back."""
    import shutil

    import grape_tpu_torch as gt
    from grape_tpu_torch.functionals import J_T_ss
    from grape_tpu_torch.io import load_result, optimize_or_load
    from grape_tpu_torch.models import (
        tls_xgate_problem, two_transmon_subspace_gate_problem,
    )
    from grape_tpu_torch.ops import hopper_cheby, hopper_frechet, hopper_prop
    from grape_tpu_torch.testing import dummy_control_problem, stirap_problem

    mods = (hopper_prop, hopper_frechet, hopper_cheby)
    out = {}

    def run(name, problem, **updates):
        series = []
        zero_counts(*mods)
        t0 = time.perf_counter()
        res = gt.optimize_problem(
            problem, dtype=np.complex64, print_iters=False,
            rethrow_exceptions=True,
            callback=lambda wrk, it: series.append(float(wrk.result.J_T)),
            **updates)
        torch.cuda.synchronize()
        counts = {k: v for k, v in read_counts(*mods).items() if v}
        require(counts.get("forward_scan_shared", 0) >= res.fg_calls >= 1,
                f"{name}: the forward kernel did not serve every "
                f"evaluation: {counts}")
        out[name] = {"J_T_series": series, "iter": res.iter,
                     "converged": bool(res.converged),
                     "message": res.message, "fg_calls": res.fg_calls,
                     "seconds": time.perf_counter() - t0,
                     "launches": counts}
        return res, series

    # BASELINE config 2 and its global phase
    xg = tls_xgate_problem(iter_stop=20)
    res, _ = run("tls_xgate", xg,
                 check_convergence=lambda r: bool(r.J_T < 1e-4))
    require(res.converged and res.J_T < 1e-3 and res.J_a > 0.0,
            f"X-gate: {res.message}, J_T {res.J_T}")
    H = xg.trajectories[0].generator
    H_opt = gt.substitute(H, list(zip(gt.get_controls(H),
                                      res.optimized_controls)))
    overlaps = np.asarray([
        np.vdot(t.target_state, gt.propagate(
            t.initial_state, H_opt, xg.tlist, dtype=np.complex64))
        for t in xg.trajectories])
    phases = np.angle(overlaps)
    spread = float(np.ptp((phases - phases[0] + np.pi) % (2 * np.pi)))
    require(np.abs(overlaps).min() > 0.999 and spread < 1e-2,
            f"X-gate global phase: overlaps {np.abs(overlaps)}, "
            f"spread {spread}")
    out["tls_xgate"].update(min_abs_overlap=float(np.abs(overlaps).min()),
                            phase_spread=spread)

    res, series = run("stirap_running_cost",
                      stirap_problem(lambda_b=0.4, iter_stop=25),
                      gradient_method="taylor")
    out["stirap_running_cost"]["golden"] = golden_check(
        "stirap_running_cost", series, res)
    require(res.iter == 25, f"STIRAP stopped after {res.iter} iterations")

    res, series = run(
        "dummy_seeded",
        dummy_control_problem(N=2, rng=np.random.default_rng(1244538994),
                              iter_stop=100),
        J_T=J_T_ss, check_convergence=lambda r: (
            "J_T < 10⁻⁵" if r.J_T < 1e-5 else ""))
    out["dummy_seeded"]["golden"] = golden_check("dummy_seeded", series, res)
    require(res.converged and res.J_T < 1e-5
            and res.message == "J_T < 10⁻⁵",
            f"seeded dummy problem: {res.message}, J_T {res.J_T}")

    res, series = run("subspace_gate", two_transmon_subspace_gate_problem(
        d=3, n_basis=6, n_steps=50, T=10.0, E0=0.2, J=0.3, iter_stop=15))
    out["subspace_gate"]["golden"] = golden_check("subspace_gate", series,
                                                  res)
    require(res.iter == 15, f"subspace gate: {res.iter} iterations")

    # optimize_or_load on the CZ at dim 100, in the checkout's build tree
    io_dir = os.path.join(HERE, "build", "chip_smoke_io")
    shutil.rmtree(io_dir, ignore_errors=True)
    fn = os.path.join(io_dir, "cz.pkl")
    kw = dict(dtype=np.complex64, print_iters=False, **cz_problem.kwargs)
    trajs, tlist = cz_problem.trajectories, cz_problem.tlist
    zero_counts(*mods)
    r1 = optimize_or_load(fn, trajs, tlist, iter_stop=3, **kw)
    torch.cuda.synchronize()
    n_written = read_counts(*mods)["forward_scan_shared"]
    zero_counts(*mods)
    r2 = optimize_or_load(fn, trajs, tlist, iter_stop=3, **kw)
    n_reload = sum(read_counts(*mods).values())
    require(os.path.exists(fn) and r1.iter == 3 and n_written >= 1
            and n_reload == 0 and r2.J_T == r1.J_T
            and r2.fg_calls == r1.fg_calls,
            f"optimize_or_load: iter {r1.iter}, reload launches {n_reload}, "
            f"J_T {r1.J_T} / {r2.J_T}")
    r3 = gt.optimize(trajs, tlist, iter_stop=5, continue_from=load_result(fn),
                     **kw)
    torch.cuda.synchronize()
    require(r3.iter == 5 and r3.J_T <= r1.J_T,
            f"resumed CZ: iter {r3.iter}, J_T {r3.J_T} after {r1.J_T}")
    out["optimize_or_load_cz"] = {
        "J_T_written": r1.J_T, "J_T_reloaded": r2.J_T,
        "forward_launches_written": n_written, "launches_reloaded": n_reload,
        "resumed_iter": r3.iter, "J_T_resumed": r3.J_T,
        "file_bytes": os.path.getsize(fn)}

    # propagate the optimized pulse, on the kernel path, against the
    # evaluation's own final states; then back to the initial states
    cp = gt.compile_problem(trajs, tlist, dtype=np.complex64,
                            **cz_problem.kwargs)
    H = trajs[0].generator
    H_opt = gt.substitute(H, list(zip(gt.get_controls(H),
                                      r3.optimized_controls)))
    x = np.concatenate([gt.discretize_on_midpoints(c, tlist)
                        for c in r3.optimized_controls])
    _, _, aux = gt.build_fg(cp)(x)
    psi_T = aux["psi_T"].cpu().numpy()
    zero_counts(*mods)
    fwd = np.stack([gt.propagate(t.initial_state, H_opt, tlist,
                                 dtype=np.complex64) for t in trajs])
    back = np.stack([gt.propagate(fwd[k], H_opt, tlist, backwards=True,
                                  dtype=np.complex64)
                     for k in range(len(trajs))])
    n_prop = read_counts(*mods)["forward_scan_shared"]
    e_fwd = float(np.abs(fwd - psi_T).max())
    e_back = float(np.abs(back - cp.psi0).max())
    # two float32 chains of 2000 steps at their own squaring counts, each
    # held to TOL_STATE against its plain version: their sum of limits
    require(n_prop == 2 * len(trajs) and e_fwd < 2 * TOL_STATE
            and e_back < 2 * TOL_STATE,
            f"propagate: {n_prop} launches, forward {e_fwd}, back {e_back}")
    out["propagate_cz"] = {"max_abs_err_vs_fg_final_states": e_fwd,
                           "max_abs_err_back_to_initial": e_back,
                           "limit": 2 * TOL_STATE,
                           "forward_scan_shared_launches": n_prop}
    shutil.rmtree(io_dir, ignore_errors=True)
    emit({"phase": "host_modules", **out})


def trace_summary(trace_dir, host=False):
    """What a ``profile_dir`` trace (Chrome trace format) says of the
    card: the number of device events, the kernels by total time, the
    device's busy share of the traced window (the span of all complete
    events, host and device) and its largest idle gaps.  ``host``: also the
    host's CUDA runtime calls and operators by total time (top-level
    operators only, so nested ones are not counted twice)."""
    files = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    require(len(files) == 1, f"profile_dir holds {files}")
    path = os.path.join(trace_dir, files[0])
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    require(spans, "the trace holds no complete event")
    device = [e for e in spans
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    t0 = min(float(e["ts"]) for e in spans)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in spans)
    out = {"trace_bytes": os.path.getsize(path), "events": len(events),
           "device_events": len(device), "window_ms": (t1 - t0) / 1e3}
    if not device:
        return out
    by_name = {}
    for e in device:
        if e["cat"] == "kernel":
            name = e.get("name", "?")[:80]
            n, us = by_name.get(name, (0, 0.0))
            by_name[name] = (n + 1, us + float(e["dur"]))
    merged = []
    for a, b in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in device):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    gaps = sorted(((b0 - a1) for (_, a1), (b0, _) in
                   zip(merged, merged[1:])), reverse=True)
    out.update(
        kernels=[{"name": k, "launches": n, "ms": us / 1e3}
                 for k, (n, us) in sorted(by_name.items(),
                                          key=lambda kv: -kv[1][1])[:12]],
        kernel_names=len(by_name),
        device_busy_ms=busy / 1e3,
        device_busy_share=busy / (t1 - t0),
        device_span_busy_share=busy / (merged[-1][1] - merged[0][0]),
        largest_idle_gaps_ms=[g / 1e3 for g in gaps[:5]])
    if host:
        out["host_by_name"] = {}
        for cat in ("cuda_runtime", "cpu_op"):
            evs = sorted((e for e in spans if e.get("cat") == cat),
                         key=lambda e: float(e["ts"]))
            if cat == "cpu_op":  # top level: not inside the previous one
                top, end = [], -1.0
                for e in evs:
                    if float(e["ts"]) >= end:
                        top.append(e)
                        end = float(e["ts"]) + float(e["dur"])
                evs = top
            tot = {}
            for e in evs:
                name = e.get("name", "?")[:60]
                n, us = tot.get(name, (0, 0.0))
                tot[name] = (n + 1, us + float(e["dur"]))
            out["host_by_name"][cat] = [
                {"name": k, "calls": n, "ms": us / 1e3}
                for k, (n, us) in sorted(tot.items(),
                                         key=lambda kv: -kv[1][1])[:8]]
    return out


def profile_phase(cz_problem, dev):
    """Phase ``profile``: ``optimize(..., profile_dir=...)`` for three
    L-BFGS-B iterations on the CZ gate (dim 100, gradgen) and on the 1024
    qutrits (taylor), each trace read back: kernel names, the device's busy
    share of the traced window and its largest idle gaps."""
    import shutil

    import grape_tpu_torch as gt
    from grape_tpu_torch.functionals import J_T_sm
    from grape_tpu_torch.models import transmon_ensemble_trajectories

    root = os.path.join(HERE, "build", "chip_smoke_profile")
    shutil.rmtree(root, ignore_errors=True)
    qutrits = transmon_ensemble_trajectories(QUTRIT_SAMPLES, d=3,
                                             T=QUTRIT_T, seed=SEED)
    cells = {
        "cz_gradgen": (cz_problem.trajectories, cz_problem.tlist,
                       dict(cz_problem.kwargs)),
        "qutrits_taylor": (qutrits,
                           np.linspace(0, QUTRIT_T, QUTRIT_STEPS + 1),
                           dict(J_T=J_T_sm, gradient_method="taylor")),
    }
    out = {}
    for cell, (trajs, tlist, kw) in cells.items():
        trace_dir = os.path.join(root, cell)
        t0 = time.perf_counter()
        res = gt.optimize(trajs, tlist, iter_stop=3, dtype=np.complex64,
                          print_iters=False, rethrow_exceptions=True,
                          profile_dir=trace_dir, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        require(res.iter == 3, f"profiled {cell}: {res.message}")
        out[cell] = {"seconds_with_trace": secs, "fg_calls": res.fg_calls,
                     "f_calls": res.f_calls, **trace_summary(trace_dir)}
    shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "profile", **out})


# ---- per-trajectory propagator settings and Krotov's method ----------------

# the heterogeneous cell: the dim-1024 Chebyshev CZ with |00>, |01> on the
# Chebyshev series and |10>, |11> on ExpProp, as trajectory attributes; its
# check against the plain versions at the dim-256 Chebyshev cell's width
HETERO_SPLIT = ("cheby", "cheby", "expprop", "expprop")
HETERO_ITERS = 3
# Krotov on the flagship CZ (dim 100, K = 4, N_T = 2000): lambda_a = 0.5
# lowers J_T monotonically (0.898 -> 0.386 -> 0.222 -> 0.198 in complex128
# on the CPU)
KROTOV_ITERS, KROTOV_LAMBDA = 3, 0.5


# a seeded pulse whose gradient is of the first order: at the guess (about
# zero on every drive at T = 1.0) the CZ's gradient is of the second order
# (8.3e-7 at its max), so the checks against the uniform builds and the
# plain versions and the optimization also run from this pulse, inside the
# guess's amplitude envelope (max(|guess|, 0.1) doubled: 0.2)
HETERO_PULSE_AMP, HETERO_PULSE_SEED = 0.15, 10


def nonflat_pulse(tlist, n_controls, amp=HETERO_PULSE_AMP,
                  seed=HETERO_PULSE_SEED):
    """``(L, N_T)`` pulse values on the intervals: per control, four seeded
    sine modes under a sine window, scaled to ``max |ε| = amp``."""
    rng = np.random.default_rng(seed)
    tl = np.asarray(tlist, dtype=np.float64)
    T = tl[-1] - tl[0]
    t = 0.5 * (tl[:-1] + tl[1:]) - tl[0]
    out = np.empty((n_controls, len(t)))
    for l in range(n_controls):
        a = rng.normal(size=4)
        ph = rng.uniform(0.0, 2 * np.pi, size=4)
        f = np.sin(np.pi * t / T) * sum(
            a[k] * np.sin((k + 1) * np.pi * t / T + ph[k]) for k in range(4))
        out[l] = amp * f / np.abs(f).max()
    return out


def hetero_problem(d, n_steps, T, guesses=None):
    """``two_transmon_cz_problem`` (with its guess, or the pulse values
    ``guesses (L, N_T)``) with the propagator of each basis state given by
    its trajectory's ``prop_method`` (``HETERO_SPLIT``) and the taylor
    gradient: ``(trajectories, tlist, kwargs, the same trajectories
    without the attribute)``."""
    import grape_tpu_torch as gt
    from grape_tpu_torch.models import two_transmon_cz_problem

    p = two_transmon_cz_problem(
        d=d, n_steps=n_steps, T=T, gradient_method="taylor",
        guesses=None if guesses is None else list(guesses))
    trajs = [gt.Trajectory(t.initial_state, t.generator,
                           target_state=t.target_state, prop_method=m)
             for t, m in zip(p.trajectories, HETERO_SPLIT)]
    return trajs, p.tlist, dict(p.kwargs), p.trajectories


def hetero_breakdown(fg, x, hp, reps=2):
    """``fg_breakdown`` of a heterogeneous evaluation by partition: each
    partition's forward pass (``fg._evaluate_forward``) and gradient pass
    (``fg._tau_grads_pass``); ``glue`` is the rest (the coefficient tables,
    the scatter of the final states, J_T and χ(T) over all trajectories,
    the assembly)."""
    kinds = {"_evaluate_forward": "forward", "_tau_grads_pass": "gradient"}

    def label(name, args, kwargs):
        p = next(i for i, q in enumerate(hp.parts) if q is args[0])
        return f"{kinds[name]}_part{p}_{args[0].fw_prop_method}"

    return fg_breakdown(fg, x, reps=reps, names=list(kinds), label=label)


HETERO_READINGS = {"J_vs_cheby": "J", "J_vs_expprop": "J",
                   "grad_vs_cheby": "grad", "grad_vs_expprop": "grad",
                   "psi_T_rows_cheby": "psi_T", "psi_T_rows_expprop": "psi_T"}


def hetero_agreement(out_h, out_c, out_e):
    """A heterogeneous evaluation ``(J, g, aux)`` against the uniform
    all-cheby and all-expprop builds' at the same pulse: J and the gradient
    against both, each row of psi_T against the build of its own method;
    the limits are max(1e-5 of the scale, twice the two uniform builds' own
    difference).  The readings, the limits and their derivation."""
    (J, g, a), (J_c, g_c, a_c), (J_e, g_e, a_e) = out_h, out_c, out_e
    mutual = {"J": abs(float(J_c) - float(J_e)), "grad": max_abs(g_c, g_e),
              "psi_T": max_abs(a_c["psi_T"], a_e["psi_T"])}
    scale = {"J": abs(float(J_c)), "grad": float(g_c.abs().max()),
             "psi_T": 1.0}
    return {
        "J": float(J), "J_uniform_cheby": float(J_c),
        "J_uniform_expprop": float(J_e), "uniform_mutual": mutual,
        "scale": scale,
        "limit": {k: max(1e-5 * scale[k], 2 * mutual[k]) for k in mutual},
        "limit_rule": "max(1e-5 * scale, "
                      "2 * |uniform cheby - uniform expprop|)",
        "J_vs_cheby": abs(float(J) - float(J_c)),
        "J_vs_expprop": abs(float(J) - float(J_e)),
        "grad_vs_cheby": max_abs(g, g_c), "grad_vs_expprop": max_abs(g, g_e),
        "psi_T_rows_cheby": max_abs(a["psi_T"][:2], a_c["psi_T"][:2]),
        "psi_T_rows_expprop": max_abs(a["psi_T"][2:], a_e["psi_T"][2:]),
    }


def hetero_paths(dev):
    """Phase ``hetero``: the dim-1024 CZ (K = 4, N_T = 100, T = 1.0,
    ``J_T_sm``, taylor) with two basis states on the Chebyshev series and
    two on ExpProp, as ``Trajectory`` attributes, through
    ``compile_heterogeneous`` / ``build_fg`` and three L-BFGS-B iterations
    of ``optimize``.  One evaluation runs the Chebyshev ring kernel both
    ways at K = 2, the wide propagator kernel at d = 1024 (the rule's route
    there) and the grid state scans forward and for the χ chain over the
    stored propagators (read in place), and two Taylor passes.  Held against
    the uniform all-cheby and all-expprop builds on the card (the same
    physics for every trajectory) at the guess and at a seeded pulse with
    a first-order gradient (``nonflat_pulse``), which the optimization
    starts from; with a control (the pulse × 1.01) that the gradient limit
    must tell apart.  At d = 1024 the ExpProp half's forward scan and χ
    chain alone, and one whole evaluation, against the plain versions;
    the propagator kernel alone (the wide route, and the global-scratch
    kernel forced) beside ``torch.linalg.matrix_exp`` on the same 100
    matrices; and the same
    split at dim 256 (``cz(16, 200, "taylor", "cheby", T=5.0)``) against
    the plain versions.  Returns ``(the counted optimization's launches,
    its route launches, the d = 1024 propagator reading, the d = 1024
    chain readings)``."""
    import grape_tpu_torch as gt
    import grape_tpu_torch.fg as F
    from grape_tpu_torch.fg_hetero import (
        compile_heterogeneous, traj_prop_partition,
    )
    from grape_tpu_torch.flops import fg_flops
    from grape_tpu_torch.ops import hopper_cheby, hopper_frechet, hopper_prop
    from grape_tpu_torch.ops import plain_versions

    t_phase = time.perf_counter()
    modules = (hopper_prop, hopper_frechet, hopper_cheby)
    trajs, tlist, kw, plain_trajs = hetero_problem(CHEBY_D, CHEBY_STEPS,
                                                   CHEBY_T)
    partition = traj_prop_partition(trajs, kw)
    hp = compile_heterogeneous(trajs, tlist, partition, dtype=np.complex64,
                               **kw)
    cp_c, cp_e = hp.parts
    pd_c = F._prop_data(cp_c)
    require(hp.dim == 1024 and hp.n_traj == 4 and hp.n_timesteps == 100
            and [i.tolist() for i in hp.part_idx] == [[0, 1], [2, 3]]
            and cp_c.fw_prop_method == "cheby"
            and cp_e.fw_prop_method == "expprop"
            and cp_c.gradient_method == cp_e.gradient_method == "taylor"
            and F._cheby_kernel_enabled(cp_c, pd_c["fw"])
            and F._cheby_kernel_enabled(cp_c, pd_c["bw"])
            and F._reuse_U_enabled(cp_e)
            and hopper_prop.propagator_route(hp.dim) == "wide"
            and hopper_prop.scan_route(hp.dim, 1, 2, torch.cuda
                                       .get_device_properties(dev)
                                       .multi_processor_count)["route"]
            == "grid",
            "the heterogeneous cell must split into a Chebyshev-kernel "
            "partition and an ExpProp partition on the wide propagator "
            "kernel and the grid scans")
    uniform = {m: gt.compile_problem(plain_trajs, tlist, dtype=np.complex64,
                                     prop_method=m, **kw)
               for m in ("cheby", "expprop")}
    x0 = hp.guess_pulsevals.reshape(-1)
    eps1 = nonflat_pulse(tlist, hp.n_controls)
    x1 = eps1.reshape(-1)
    fg_h = counted(gt.build_fg(hp))
    fg_u = {m: gt.build_fg(cp) for m, cp in uniform.items()}
    out_u = {m: fg(x0) for m, fg in fg_u.items()}
    out_u1 = {m: fg(x1) for m, fg in fg_u.items()}
    g_control = fg_u["cheby"](x1 * (1.0 + 1e-2))[1]
    torch.cuda.synchronize()
    reps = 3
    ms = {f"uniform_{m}": timed_ms(lambda fg=fg: fg(x0), reps)
          for m, fg in fg_u.items()}

    # ---- the counted run: one heterogeneous evaluation --------------------
    zero_counts(*modules)
    for key in hopper_cheby.launches_by_direction:
        hopper_cheby.launches_by_direction[key] = 0
    J, g, aux = fg_h(x0)
    torch.cuda.synchronize()
    counts_one, routes_one = (
        {k: v for k, v in c.items() if v} for c in read_launches(*modules))
    by_dir = dict(hopper_cheby.launches_by_direction)
    require(counts_one == {"forward_scan_shared": 1, "chi_scan_shared": 1,
                           "cheby_scan": 2}
            and by_dir == {"forward": 1, "adjoint": 1}
            and routes_one == {"propagators_wide": 1,
                               "state_scan_grid_forward": 1,
                               "state_scan_grid_chi": 1,
                               "cheby_ring": 2},
            f"one heterogeneous evaluation launched {counts_one} {by_dir} "
            f"on the routes {routes_one}")
    require(bool(torch.isfinite(g).all()) and math.isfinite(float(J))
            and bool(aux["chi_ok"]) and bool(aux["taylor_ok"])
            and aux["psi_T"].shape == (4, hp.dim),
            "the heterogeneous evaluation is not finite or not converged")

    # ---- against the uniform builds, at the guess and the seeded pulse ----
    agreement = {
        "guess": hetero_agreement((J, g, aux), out_u["cheby"],
                                  out_u["expprop"]),
        "nonflat": hetero_agreement(fg_h(x1), out_u1["cheby"],
                                    out_u1["expprop"]),
    }
    agreement["nonflat"]["pulse"] = {"amplitude": HETERO_PULSE_AMP,
                                     "seed": HETERO_PULSE_SEED}
    agreement["nonflat"]["control_grad_vs_cheby_pulse_x1.01"] = max_abs(
        g_control, out_u1["cheby"][1])

    # ---- times ------------------------------------------------------------
    ms["hetero"] = timed_ms(lambda: fg_h(x0), reps)
    by_part = hetero_breakdown(fg_h, x0, hp)
    kernel_parts = fg_breakdown(fg_h, x0, reps=2)
    flops_h = sum(fg_flops(p) for p in hp.parts)
    f_h = counted(gt.build_f(hp))
    Jf, _ = f_h(x0)
    require(abs(float(Jf) - float(J)) < 1e-6,
            "build_f disagrees with build_fg on the heterogeneous cell")

    # ---- three L-BFGS-B iterations through optimize, from the pulse -------
    trajs1, _, _, _ = hetero_problem(CHEBY_D, CHEBY_STEPS, CHEBY_T,
                                     guesses=eps1)
    series, wrks = [], []

    def record(wrk, iteration):
        series.append(float(wrk.result.J_T))
        wrks[:] = [wrk]

    t0 = time.perf_counter()
    res = gt.optimize(trajs1, tlist, iter_stop=HETERO_ITERS,
                      dtype=np.complex64, print_iters=False,
                      rethrow_exceptions=True, callback=record, **kw)
    torch.cuda.synchronize()
    opt_s = time.perf_counter() - t0
    counts, routes = read_launches(*modules)
    by_dir = dict(hopper_cheby.launches_by_direction)
    n_fg = fg_h.calls + res.fg_calls
    n_f = f_h.calls + res.f_calls
    expect = dict.fromkeys(counts, 0)
    expect.update({"forward_scan_shared": n_fg + n_f,
                   "chi_scan_shared": n_fg,
                   "cheby_scan": 2 * n_fg + n_f})
    expect_routes = dict.fromkeys(routes, 0)
    expect_routes.update({"propagators_wide": n_fg + n_f,
                          "state_scan_grid_forward": n_fg + n_f,
                          "state_scan_grid_chi": n_fg,
                          "cheby_ring": 2 * n_fg + n_f})
    # J_T must fall by more than ten times the uniform builds' own
    # difference in J at the starting pulse
    fall_floor = 10 * agreement["nonflat"]["uniform_mutual"]["J"]
    ok_series = (len(series) == HETERO_ITERS + 1
                 and res.iter == HETERO_ITERS
                 and np.array_equal(wrks[0].cp.guess_pulsevals, eps1)
                 and all(math.isfinite(v) for v in series)
                 and all(b <= a for a, b in zip(series, series[1:]))
                 and series[0] - series[-1] > fall_floor)
    emit_hetero = {
        "phase": "hetero", "dim": hp.dim, "K": hp.n_traj,
        "N_T": hp.n_timesteps, "split": list(HETERO_SPLIT),
        "partitions": [{"trajectories": i.tolist(),
                        "fw_prop_method": p.fw_prop_method,
                        "gradient_method": p.gradient_method}
                       for p, i in zip(hp.parts, hp.part_idx)],
        "agreement": agreement,
        "launches_one_eval": counts_one, "routes_one_eval": routes_one,
        "ms_per_eval": ms["hetero"], "ms_per_eval_uniform_cheby":
            ms["uniform_cheby"], "ms_per_eval_uniform_expprop":
            ms["uniform_expprop"],
        "device_ms_by_part": by_part, "device_ms_by_kernel": kernel_parts,
        "flop_rate": {"fg_flops": flops_h,
                      "tflops_per_s": flops_h / (ms["hetero"] * 1e-3) / 1e12},
        "optimize": {"start": "the seeded pulse", "J_T_series": series,
                     "J_T_fall": series[0] - series[-1] if series else None,
                     "J_T_fall_floor": fall_floor, "iterations": res.iter,
                     "seconds": opt_s, "fg_calls": res.fg_calls,
                     "f_calls": res.f_calls, "message": res.message,
                     "envelope_bucket_growths":
                         len(wrks[0]._program_cache) - 1 if wrks else None},
        "evaluations_counted": {"fg": n_fg, "f": n_f},
        "launches": {k: v for k, v in counts.items() if v},
        "route_launches": {k: v for k, v in routes.items() if v},
        "launches_by_direction": by_dir,
    }

    # ---- the propagator kernel alone at d = 1024: the wide route, and the
    # global-scratch kernel forced ------------------------------------------
    H0, ops = cp_e.H0[0], cp_e.ops[0]
    c64 = lambda a: torch.tensor(np.ascontiguousarray(a),
                                 dtype=torch.complex64, device=dev)
    c128 = lambda x: x.to(torch.complex128 if x.is_complex()
                          else torch.float64)
    H0_t, ops_t = c64(H0), c64(ops)

    def coeff_table(eps):
        return torch.tensor(np.einsum("ntl,ln->nt", cp_e.M, eps) + cp_e.Mfix,
                            dtype=torch.float32, device=dev)

    coeffs = coeff_table(hp.guess_pulsevals)
    dts = torch.tensor(np.diff(cp_e.tlist), dtype=torch.float32, device=dev)
    s_e = F._static_squarings(cp_e)
    zero_counts(hopper_prop)
    prop_call = lambda: hopper_prop.propagators_shared(H0_t, ops_t, coeffs,
                                                       dts, s_e)
    U = prop_call()
    torch.cuda.synchronize()
    require(read_launches(hopper_prop)[1]["propagators_wide"] == 1,
            "the d = 1024 propagators did not take the wide route")
    prop_ms = median_ms(prop_call, reps=3)
    with hopper_prop._forced_routes(propagators="global"):
        U_g = prop_call()
        prop_global_ms = median_ms(prop_call, reps=3)
    e_global = max_abs(U_g, U)
    del U_g
    # the plain version of the propagator half (the wrapper has none of
    # its own: it always launches)
    plain_call = lambda: hopper_prop._propagators_plain(
        H0_t[None], ops_t[None], coeffs, dts, s_e)[:, 0]
    U_p = plain_call()
    prop_plain_ms = median_ms(plain_call, reps=1)
    A_lib = (-1j * dts.to(torch.complex64))[:, None, None] * (
        H0_t[None] + torch.einsum("nt,tij->nij",
                                  coeffs.to(torch.complex64), ops_t))
    U_lib = torch.linalg.matrix_exp(A_lib)
    prop_lib_ms = median_ms(lambda: torch.linalg.matrix_exp(A_lib), reps=3)
    d, N_T = hp.dim, hp.n_timesteps
    prop_flops = N_T * (6 + s_e) * 6.0 * d ** 3
    prop_bytes = nbytes(H0_t, ops_t, coeffs, dts, U)
    b_ms, b_by = bound(prop_flops, prop_bytes)
    b8_ms, _ = bound(N_T * (6 + s_e) * 8.0 * d ** 3, prop_bytes)
    e_plain = max_abs(U, U_p)
    e_lib = max_abs(U, U_lib)
    require(e_plain < TOL_STATE and e_lib < TOL_STATE,
            f"the d = 1024 propagators disagree: plain {e_plain}, "
            f"matrix_exp {e_lib}")
    del U, U_p, U_lib, A_lib
    wide_d1024 = {"d": d, "N_T": N_T, "squarings": s_e, "ms": prop_ms,
                  "global_route_ms": prop_global_ms,
                  "plain_ms": prop_plain_ms, "library_ms": prop_lib_ms,
                  "library_call": "torch.linalg.matrix_exp on the same "
                                  "(N_T, d, d) matrices",
                  "bound_ms": b_ms, "bound_by": b_by,
                  "bound_ms_8d3": b8_ms,
                  "max_abs_err_vs_plain": e_plain,
                  "max_abs_err_vs_library": e_lib,
                  "max_abs_diff_vs_global_route": e_global,
                  "launches_hetero_optimize": routes["propagators_wide"]}
    emit_hetero["propagators_wide_d1024"] = wide_d1024

    # ---- the ExpProp half's chains at d = 1024 against the plain versions:
    # the grid scans both ways, on the partition's inputs at the seeded
    # pulse (K = 2) ----------------------------------------------------------
    rng = np.random.default_rng(HETERO_PULSE_SEED)
    chi0 = rng.normal(size=(2, d)) + 1j * rng.normal(size=(2, d))
    chi0 = c64(chi0 / np.linalg.norm(chi0, axis=1, keepdims=True))
    psi0 = c64(cp_e.psi0)
    co1 = coeff_table(eps1)
    zero_counts(hopper_prop)
    st, U1 = hopper_prop.forward_scan_shared(H0_t, ops_t, co1, dts, psi0, s_e)
    chis = hopper_prop.chi_scan_shared(U1, chi0)
    torch.cuda.synchronize()
    routes_chain = {k: v for k, v in read_launches(hopper_prop)[1].items()
                    if v}
    with plain_versions():
        st_p, U1_p = hopper_prop.forward_scan_shared(H0_t, ops_t, co1, dts,
                                                     psi0, s_e)
        chis_p = hopper_prop.chi_scan_shared(U1, chi0)
    # the kernel's own propagators applied plainly: the forward scan alone
    psi, e_apply = psi0, 0.0
    for n in range(N_T):
        psi = psi @ U1[n].transpose(-1, -2)
        e_apply = max(e_apply, max_abs(psi, st[n + 1]))
    # the whole forward scan against the plain one: within the larger of
    # TOL_STATE and twice the plain float32 chain's distance from complex128
    st_x, _ = hopper_prop.forward_scan_shared_plain(
        c128(H0_t), c128(ops_t), c128(co1), c128(dts), c128(psi0), s_e)
    drift = max_abs(st_p.to(torch.complex128), st_x)
    chains = {"K": 2, "d": d, "N_T": N_T, "squarings": s_e,
              "routes": routes_chain,
              "forward_scan_vs_plain_on_kernel_U": e_apply,
              "chi_scan_vs_plain_on_kernel_U": max_abs(chis, chis_p),
              "propagators_vs_plain": max_abs(U1, U1_p),
              "forward_states_vs_plain": max_abs(st, st_p),
              "plain_float32_states_vs_complex128": drift,
              "forward_states_limit": max(TOL_STATE, 2 * drift),
              "limit": TOL_STATE}
    del st, U1, st_p, U1_p, st_x, chis, chis_p
    emit_hetero["chains_d1024_vs_plain"] = chains

    # ---- one whole evaluation at d = 1024 against the plain versions ------
    zero_counts(*modules)
    J1, _, _, dJ1, dg1 = fg_against_plain(fg_h, x1, "hetero dim 1024")
    routes1 = {k: v for k, v in read_launches(*modules)[1].items() if v}
    emit_hetero["dim1024_vs_plain"] = {
        "pulse": "the seeded pulse", "J": float(J1),
        "J_abs_diff_vs_plain": dJ1, "grad_diff_of_max_vs_plain": dg1,
        "route_launches": routes1}

    # ---- dim 256: the kernels against the plain versions ------------------
    trajs2, tlist2, kw2, _ = hetero_problem(CHEBY256_D, CHEBY256_STEPS,
                                            CHEBY256_T)
    hp2 = compile_heterogeneous(trajs2, tlist2,
                                traj_prop_partition(trajs2, kw2),
                                dtype=np.complex64, **kw2)
    x2 = hp2.guess_pulsevals.reshape(-1)
    zero_counts(*modules)
    J2, g2, aux2, dJ2, dg2 = fg_against_plain(gt.build_fg(hp2), x2,
                                              "hetero dim 256")
    counts2, routes2 = (
        {k: v for k, v in c.items() if v} for c in read_launches(*modules))
    require(counts2 == {"forward_scan_shared": 1, "chi_scan_shared": 1,
                        "cheby_scan": 2}
            and routes2.get("cheby_ring") == 2
            and routes2.get("propagators_wide") == 1,
            f"hetero dim 256: kernel launches {counts2} {routes2}")
    emit_hetero["dim256_vs_plain"] = {
        "dim": hp2.dim, "N_T": hp2.n_timesteps, "J": float(J2),
        "J_abs_diff_vs_plain": dJ2, "grad_diff_of_max_vs_plain": dg2,
        "launches": counts2, "route_launches": routes2}
    emit_hetero["seconds"] = time.perf_counter() - t_phase
    emit(emit_hetero)
    for where, agr in agreement.items():
        for k, key in HETERO_READINGS.items():
            require(agr[k] <= agr["limit"][key],
                    f"hetero at the {where} pulse: {k} = {agr[k]} exceeds "
                    f"{agr['limit'][key]}")
    ctl = agreement["nonflat"]["control_grad_vs_cheby_pulse_x1.01"]
    require(ctl > agreement["nonflat"]["limit"]["grad"],
            f"hetero: the control gradient ({ctl}) is inside the limit")
    require(counts == expect and routes == expect_routes,
            f"hetero optimize: launches {counts} {routes} do not match the "
            f"evaluations {expect} {expect_routes}")
    require(ok_series, f"hetero optimize: {res.message}, series {series}")
    require(routes_chain == {"propagators_wide": 1,
                             "state_scan_grid_forward": 1,
                             "state_scan_grid_chi": 1}
            and chains["forward_scan_vs_plain_on_kernel_U"] < TOL_STATE
            and chains["chi_scan_vs_plain_on_kernel_U"] < TOL_STATE
            and chains["propagators_vs_plain"] < TOL_STATE
            and chains["forward_states_vs_plain"]
            < chains["forward_states_limit"],
            f"the d = 1024 chains against the plain versions: {chains}")
    require(routes1 == {"propagators_wide": 1,
                        "state_scan_grid_forward": 1,
                        "state_scan_grid_chi": 1,
                        "cheby_ring": 2},
            f"hetero dim 1024 against plain took the routes {routes1}")
    require(prop_ms < prop_global_ms, "the wide propagator kernel is slower "
            f"than the global one at dim 1024: {wide_d1024}")
    return counts, routes, wide_d1024, chains


# the CZ at 12 levels a transmon: dim 144, N_T = 2000, ExpProp, taylor
DIM144_LEVELS = 12


def dim144_path(dev):
    """Phase ``fg_dim144``: ``two_transmon_cz_problem(d=12)`` (dim 144,
    K = 4, N_T = 2000, T = 50, ExpProp) with the taylor gradient through
    ``compile_problem`` / ``build_fg``: one evaluation against the plain
    versions forced and against the plain complex128 evaluation, its time,
    ``device_ms_by_part`` and ``flop_rate``, with the counts set to 0 just
    before the counted evaluations and read just after: the wide
    propagator kernel once per forward pass (past d = 108), the cluster
    scans (d = 144 is inside their ring).  Over 2000 steps at dim 144 the
    plain float32 evaluation itself is some 2e-5 from complex128 in J, so
    J is held, against plain and against complex128, to the larger of 1e-5
    and twice the plain float32 evaluation's distance from complex128 (the
    rule of the non-Hermitian chains); the gradient to 2e-3 of its max
    against plain and 1e-3 against complex128.  Returns the route
    launches."""
    import grape_tpu_torch as gt
    from grape_tpu_torch.fg import (
        _static_squarings, _vectorized_taylor_orders,
    )
    from grape_tpu_torch.models import two_transmon_cz_problem
    from grape_tpu_torch.ops import hopper_cheby, hopper_frechet, hopper_prop
    from grape_tpu_torch.ops import plain_versions

    t0 = time.perf_counter()
    modules = (hopper_prop, hopper_frechet, hopper_cheby)
    p = two_transmon_cz_problem(d=DIM144_LEVELS, gradient_method="taylor")
    cp = gt.compile_problem(p.trajectories, p.tlist, dtype=np.complex64,
                            **p.kwargs)
    require((cp.dim, cp.n_traj, cp.n_timesteps) == (144, 4, 2000)
            and cp.fw_prop_method == "expprop"
            and cp.gradient_method == "taylor"
            and hopper_prop.propagator_route(cp.dim) == "wide",
            "the dim-144 CZ must run ExpProp with the taylor gradient on the "
            "wide propagator kernel")
    cp128 = gt.compile_problem(p.trajectories, p.tlist, dtype=np.complex128,
                               **p.kwargs)
    fg = counted(gt.build_fg(cp))
    x0 = cp.guess_pulsevals.reshape(-1)
    # the references: the plain complex128 and float32 evaluations
    J128, g128, _ = gt.build_fg(cp128)(x0)
    with plain_versions():
        J_p, _, _ = fg(x0)
    drift = abs(float(J_p) - float(J128))
    tol_J = max(1e-5, 2 * drift)
    zero_counts(*modules)
    n0 = fg.calls
    J, g, aux, dJ, dg = fg_against_plain(fg, x0, "dim 144", tol_J=tol_J)
    dJ128 = abs(float(J) - float(J128))
    dg128 = max_abs(g.double(), g128) / float(g128.abs().max())
    require(dJ128 < tol_J and dg128 < 1e-3,
            f"dim 144 against complex128: J {dJ128} (limit {tol_J}), "
            f"gradient {dg128} of its max")
    ms = timed_ms(lambda: fg(x0), 3)
    parts = fg_breakdown(fg, x0)
    counts = read_counts(*modules)
    routes = dict(ROUTE_READS[-1][1])
    # the plain evaluation of fg_against_plain launches none
    n = fg.calls - n0 - 1
    require(bool(aux["taylor_ok"])
            and counts["forward_scan_shared"] == n
            and counts["chi_scan_shared"] == n
            and routes["propagators_wide"] == n
            and routes["state_scan_forward"] == n
            and routes["state_scan_chi"] == n,
            f"dim 144: {n} evaluations launched {counts} on {routes}")
    emit({"phase": "fg_dim144", "dim": cp.dim, "K": cp.n_traj,
          "N_T": cp.n_timesteps, "squarings": _static_squarings(cp),
          "J": float(J), "J_complex128": float(J128),
          "J_abs_diff_vs_plain": dJ, "J_abs_diff_vs_complex128": dJ128,
          "plain_float32_J_vs_complex128": drift, "J_limit": tol_J,
          "J_limit_rule": "max(1e-5, 2 * |J plain float32 - J complex128|)",
          "grad_diff_of_max_vs_plain": dg,
          "grad_diff_of_max_vs_complex128": dg128, "ms_per_eval": ms,
          "flop_rate": flop_rate(cp, ms), "device_ms_by_part": parts,
          "taylor_orders": _vectorized_taylor_orders(cp),
          "evaluations_counted": n,
          "launches": {k: v for k, v in counts.items() if v},
          "route_launches": {k: v for k, v in routes.items() if v},
          "seconds": time.perf_counter() - t0})
    zero_counts(*modules)
    return routes


def krotov_paths(cz_problem, dev):
    """Phase ``krotov``: Krotov's method on the card.  The flagship CZ
    (dim 100, K = 4, N_T = 2000) for three iterations at ``KROTOV_LAMBDA``,
    J_T falling monotonically, each iteration's time split into the
    forward pass (K1), the χ chain (K2) and the sweep, with the sweep's
    host decisions on its squaring count; one iteration with the kernels
    against the plain versions (``eps_new``, J_T), within the larger of a
    base limit and twice the plain float32 iteration's distance from a
    complex128 one; the per-trajectory generator ensemble of the reference
    tests through K5 and the grouped χ chain; and the Krotov→GRAPE
    continuation of ``examples/07``.  Returns the counted run's
    launches."""
    import grape_tpu_torch as gt
    from grape_tpu_torch import krotov
    from grape_tpu_torch.functionals import J_T_sm
    from grape_tpu_torch.models import transmon_ensemble_trajectories
    from grape_tpu_torch.ops import hopper_cheby, hopper_frechet, hopper_prop
    from grape_tpu_torch.ops import plain_versions
    from grape_tpu_torch.shapes import flattop

    t_phase = time.perf_counter()
    modules = (hopper_prop, hopper_frechet, hopper_cheby)
    trajs, tlist = cz_problem.trajectories, cz_problem.tlist
    J_T = cz_problem.kwargs["J_T"]

    # spans of the three phases of every iteration, and the stats
    spans, steps = [], []
    originals = {n: getattr(krotov, n) for n in
                 ("_evaluate_forward", "_chi_trajectory", "_sweep",
                  "_build_krotov_step")}

    def shim(name, fn):
        def wrapped(*args, **kwargs):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kwargs)
            b.record()
            spans.append((name, a, b))
            return out
        return wrapped

    def build_step(*args, **kwargs):
        step = originals["_build_krotov_step"](*args, **kwargs)
        steps.append(step)

        def timed(flat):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = step(flat)
            b.record()
            spans.append(("iteration", a, b))
            spans.append(("stats", dict(step.stats), None))
            return out
        timed.stats = step.stats
        return timed

    for n in ("_evaluate_forward", "_chi_trajectory", "_sweep"):
        setattr(krotov, n, shim(n, originals[n]))
    krotov._build_krotov_step = build_step
    series = []
    try:
        zero_counts(*modules)
        t0 = time.perf_counter()
        res = gt.optimize_krotov(
            trajs, tlist, J_T=J_T, lambda_a=KROTOV_LAMBDA,
            iter_stop=KROTOV_ITERS, dtype=np.complex64, print_iters=False,
            rethrow_exceptions=True,
            callback=lambda r, i: series.append(float(r.J_T)))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = read_counts(*modules)
    finally:
        for n, fn in originals.items():
            setattr(krotov, n, fn)
    routes = ROUTE_READS[-1][1]
    per_iter, cur = [], {}
    for name, a, b in spans:
        if name == "stats":
            per_iter[-1].update(a)
            continue
        ms_ = a.elapsed_time(b)
        if name == "iteration":
            cur["total_ms"] = ms_
            cur["other_ms"] = ms_ - sum(
                v for k, v in cur.items() if k.endswith("_ms")
                and k != "total_ms")
            per_iter.append(cur)
            cur = {}
        else:
            key = {"_evaluate_forward": "forward_ms",
                   "_chi_trajectory": "chi_ms", "_sweep": "sweep_ms"}[name]
            cur[key] = cur.get(key, 0.0) + ms_
    expect = dict.fromkeys(counts, 0)
    expect.update({"forward_scan_shared": KROTOV_ITERS,
                   "chi_scan_shared": KROTOV_ITERS})
    expect_routes = dict.fromkeys(routes, 0)
    expect_routes.update({"propagators_cluster": KROTOV_ITERS,
                          "state_scan_forward": KROTOV_ITERS,
                          "state_scan_chi": KROTOV_ITERS})
    out = {"phase": "krotov",
           "cz": {"dim": len(trajs[0].initial_state), "K": len(trajs),
                  "N_T": len(tlist) - 1, "lambda_a": KROTOV_LAMBDA,
                  "J_T_series": series, "iterations": res.iter,
                  "seconds": run_s, "per_iteration": per_iter,
                  "launches": {k: v for k, v in counts.items() if v},
                  "route_launches": {k: v for k, v in routes.items() if v},
                  "message": res.message}}

    # ---- one iteration, kernels against the plain versions ----------------
    cps = {dt: gt.compile_problem(trajs, tlist, dtype=dt, J_T=J_T)
           for dt in (np.complex64, np.complex128)}
    L, N_T = cps[np.complex64].n_controls, len(tlist) - 1
    S = np.ones((L, N_T))
    lam = np.full(L, KROTOV_LAMBDA)
    x0 = cps[np.complex64].guess_pulsevals.reshape(-1)
    zero_counts(*modules)
    r_k = krotov._build_krotov_step(cps[np.complex64], S, lam)(x0)
    checked = {k: v for k, v in read_launches(*modules)[0].items() if v}
    with plain_versions():
        r_p = krotov._build_krotov_step(cps[np.complex64], S, lam)(x0)
    r_x = krotov._build_krotov_step(cps[np.complex128], S, lam)(x0)
    eps_scale = max(float(np.abs(r_x[1]).max()), 1.0)
    e_eps = float(np.abs(r_k[1] - r_p[1]).max())
    d_eps = float(np.abs(r_p[1] - r_x[1]).max())
    e_J = abs(r_k[2] - r_p[2])
    d_J = abs(r_p[2] - r_x[2])
    lim_eps = max(TOL_STATE * eps_scale, 2 * d_eps)
    lim_J = max(1e-5, 2 * d_J)
    out["kernels_vs_plain"] = {
        "launches": checked, "eps_new_max_abs_diff": e_eps,
        "eps_new_plain_vs_complex128": d_eps, "eps_new_limit": lim_eps,
        "J_T_new": r_k[2], "J_T_new_abs_diff": e_J,
        "J_T_new_plain_vs_complex128": d_J, "J_T_new_limit": lim_J,
        "limit_rule": "max(base, 2 * |plain complex64 - complex128|)"}

    # ---- the per-trajectory generator ensemble: K5 and the grouped chain --
    ens = transmon_ensemble_trajectories(4, d=3, T=4.0)
    tl_ens = np.linspace(0.0, 4.0, 41)
    Js_ens = []
    zero_counts(*modules)
    res_e = gt.optimize_krotov(
        ens, tl_ens, J_T=J_T_sm, lambda_a=0.5, iter_stop=12,
        dtype=np.complex64, print_iters=False, rethrow_exceptions=True,
        callback=lambda r, i: Js_ens.append(float(r.J_T)))
    counts_e = {k: v for k, v in read_counts(*modules).items() if v}
    out["ensemble"] = {"K": len(ens), "J_T_series": Js_ens,
                       "launches": counts_e,
                       "route_launches": {k: v for k, v in
                                          ROUTE_READS[-1][1].items() if v}}

    # ---- examples/07: Krotov -> GRAPE continuation ------------------------
    T_tls = 5.0

    def guess(t):
        return 0.2 * float(flattop(t, T=T_tls, t_rise=0.3, func="blackman"))

    def shape(t):
        return float(flattop(t, T=T_tls, t_rise=0.3, func="blackman"))

    H = gt.hamiltonian(np.diag([-0.5, 0.5]).astype(complex),
                       (np.array([[0, 1], [1, 0]], dtype=complex), guess))
    tl_tls = np.linspace(0, T_tls, 501)
    traj = gt.Trajectory([1, 0], H, target_state=[0, 1])
    kres = gt.optimize_krotov([traj], tl_tls, J_T=J_T_sm, lambda_a=2.0,
                              update_shape=shape, iter_stop=4,
                              print_iters=False, rethrow_exceptions=True)
    J_k = float(kres.J_T)
    iter_k = kres.iter
    gres = gt.optimize([traj], tl_tls, J_T=J_T_sm, continue_from=kres,
                       iter_stop=10, print_iters=False,
                       rethrow_exceptions=True)
    out["continuation"] = {"krotov_iter": iter_k, "krotov_J_T": J_k,
                           "grape_iter": gres.iter,
                           "grape_J_T": float(gres.J_T)}
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    require(len(series) == KROTOV_ITERS + 1
            and all(math.isfinite(v) for v in series)
            and all(b < a for a, b in zip(series, series[1:])),
            f"Krotov on the CZ: J_T does not fall monotonically: {series}")
    require(counts == expect and routes == expect_routes,
            f"Krotov launches {counts} {routes} do not match "
            f"{expect} {expect_routes}")
    # the norm bound on the update holds for unitary chains: one squaring
    # decision a sweep, no sweep repeated
    require(all(it["squaring_decisions"] == 1 for it in per_iter)
            and len(per_iter) == KROTOV_ITERS,
            f"Krotov iterations: {per_iter}")
    require(checked == {"forward_scan_shared": 1, "chi_scan_shared": 1},
            f"the checked Krotov iteration launched {checked}")
    require(e_eps <= lim_eps and e_J <= lim_J,
            f"Krotov kernels vs plain: eps {e_eps} (limit {lim_eps}), "
            f"J_T {e_J} (limit {lim_J})")
    require(counts_e == {"forward_scan_pertraj": 12, "chi_scan_grouped": 12}
            and Js_ens[-1] < 0.5 * Js_ens[0]
            and all(b <= a + 1e-6 for a, b in zip(Js_ens, Js_ens[1:])),
            f"Krotov ensemble: {Js_ens}, launches {counts_e}")
    require(iter_k == 4 and J_k < 0.5 and gres.J_T < 1e-3
            and gres.iter > 4,
            f"Krotov -> GRAPE: Krotov {iter_k} iterations J_T {J_k}, "
            f"GRAPE {gres.iter} iterations J_T {gres.J_T}")
    return counts


# ---- the optimizer backends and the device-resident loop -------------------

# iterations of each backend's run on the three cells (the host loop
# against the device loop), of the Adam run on the CZ, and the device
# loop's chunk sizes on the CZ
OPT_ITERS, ADAM_ITERS, ADAM_LR = 10, 5, 2e-3
DEVICE_CHUNKS = (1, 5)
# the device loop's J_T series at one and at five iterations a chunk: the
# same arithmetic in another grouping of host calls
TOL_CHUNK_SERIES = 1e-6
# the profiled runs of both loops on the 8 x 4 ensemble
PROFILE_ITERS = 5


def optimizer_cells(cz_problem, ens_problem):
    """The three cells of the host-loop/device-loop comparison: ``{name:
    (trajectories, tlist, optimize keywords, expected launches as a
    function of the fg and f evaluations)}``."""
    from grape_tpu_torch.functionals import J_T_sm
    from grape_tpu_torch.models import transmon_ensemble_trajectories

    qutrits = transmon_ensemble_trajectories(QUTRIT_SAMPLES, d=3,
                                             T=QUTRIT_T, seed=SEED)
    return {
        "cz": (cz_problem.trajectories, cz_problem.tlist,
               dict(cz_problem.kwargs),
               lambda fg, f: {"forward_scan_shared": fg + f,
                              "chi_scan_shared": fg,
                              "frechet_trace_shared_factored": fg}),
        "ensemble_8x4": (ens_problem.trajectories, ens_problem.tlist,
                         dict(ens_problem.kwargs),
                         lambda fg, f: {"forward_scan_grouped": fg + f,
                                        "chi_scan_grouped": fg,
                                        "frechet_trace_pertraj_factored":
                                            fg}),
        "qutrits": (qutrits, np.linspace(0, QUTRIT_T, QUTRIT_STEPS + 1),
                    dict(J_T=J_T_sm, gradient_method="taylor"),
                    lambda fg, f: {"forward_scan_smalld": fg + f,
                                   "chi_scan_grouped": fg}),
    }


def backend_run(cell, optimizer, iters, backend_class, time_final=False,
                **extra):
    """One counted ``optimize`` run of ``cell`` (from
    :func:`optimizer_cells`) with ``optimizer=``: the backend that ran (read
    at ``run_optimizer``, required to be ``backend_class``), the J_T series, the steady rates over iterations
    1..iters, fg per iteration, the squaring count of the first and the
    last envelope bucket, and the kernel launches, which must equal the
    evaluations: the counted ones and those of the iterations the device
    loop discarded.  ``time_final``: one fg of the last bucket at the last
    pulse, timed after the counted run (what the loop's evaluations cost,
    against ``ms_per_eval`` at the guess)."""
    import grape_tpu_torch as gt
    from grape_tpu_torch.fg import _static_squarings
    from grape_tpu_torch.ops import hopper_cheby, hopper_frechet, hopper_prop

    opt_mod = sys.modules["grape_tpu_torch.optimize"]
    trajs, tlist, kw, expect_fn = cell
    backends, series, secs, fgs, first = [], [], [], [], []

    def spy(backend, *args):
        backends.append(backend)
        return run_optimizer(backend, *args)

    def record(wrk, iteration):
        series.append(float(wrk.result.J_T))
        secs.append(float(wrk.result.secs))
        fgs.append(int(wrk.fg_count[0]) + int(wrk.fg_count[1]))
        buckets.append(wrk._amp_bucket)
        if not first:
            first.append(wrk)

    buckets = []
    run_optimizer = opt_mod.run_optimizer
    zero_counts(hopper_prop, hopper_frechet, hopper_cheby)
    opt_mod.run_optimizer = spy
    try:
        t0 = time.perf_counter()
        res = gt.optimize(trajs, tlist, iter_stop=iters, dtype=np.complex64,
                          print_iters=False, rethrow_exceptions=True,
                          callback=record, optimizer=optimizer,
                          **kw, **extra)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        opt_mod.run_optimizer = run_optimizer
    counts = read_counts(hopper_prop, hopper_frechet, hopper_cheby)
    backend = backends[0]
    require(type(backend).__name__ == backend_class,
            f"optimizer={optimizer!r} ran {type(backend).__name__}, not "
            f"{backend_class}")
    discarded = getattr(backend, "discarded_evaluations", 0)
    n_fg, n_f = res.fg_calls + discarded, res.f_calls
    expect = dict.fromkeys(counts, 0)
    expect.update(expect_fn(n_fg, n_f))
    require(len(series) == iters + 1 and res.iter == iters
            and all(math.isfinite(v) for v in series),
            f"{type(backend).__name__}: {res.message}, series {series}")
    require(counts == expect, f"{type(backend).__name__} launches {counts} "
            f"do not match the evaluations {expect}")
    steady_s = sum(secs[1:])
    wrk = first[0]
    squarings = [_static_squarings(wrk.cp, np.asarray(b))
                 if b is not None else 0 for b in buckets]
    # the iterations whose bucket is the guess's: the loop's cost at the
    # guess's squaring count
    same_s = [i for i in range(1, iters + 1)
              if squarings[i] == squarings[0]]
    out = {"backend": type(backend).__name__,
           "chunk_iters": getattr(backend, "chunk_iters", None),
           "J_T_series": series, "iterations": res.iter,
           "seconds": seconds, "iteration_seconds": secs,
           "iteration_evaluations": fgs,
           "steady_ms_per_fg": steady_s / max(sum(fgs[1:]), 1) * 1e3,
           "steady_iters_per_second": iters / steady_s,
           "fg_per_iteration": sum(fgs[1:]) / iters,
           "fg_calls": res.fg_calls, "f_calls": res.f_calls,
           "discarded_evaluations": discarded, "message": res.message,
           "launches": counts,
           "launches_per_evaluation": {
               k: counts[k] / v for k, v in expect.items() if v},
           "iteration_squarings": squarings,
           "steady_ms_per_fg_at_guess_squarings": (
               sum(secs[i] for i in same_s)
               / max(sum(fgs[i] for i in same_s), 1) * 1e3),
           "iterations_at_guess_squarings": len(same_s)}
    if time_final:
        guess_fg = wrk._program_cache[buckets[0]][0]
        x0 = torch.as_tensor(wrk.cp.guess_pulsevals.reshape(-1),
                             device=wrk.cp.device)
        x = torch.as_tensor(wrk.pulsevals, device=wrk.cp.device)
        guess_fg(x0)
        out["ms_per_eval_at_guess"] = timed_ms(lambda: guess_fg(x0), 3)
        wrk.fg(x)
        out["ms_per_eval_at_final_pulse"] = timed_ms(lambda: wrk.fg(x), 3)
    return out


def warm_optimizer_code(dev):
    """The first calls of the device loop's tensor code and of
    ``torch.optim`` on the card (lazy imports, library handles), made
    before the counted runs so that none of them pays for it."""
    from grape_tpu_torch.optimizers.torch_lbfgs import make_lbfgs_iter

    f64 = dict(dtype=torch.float64, device=dev)
    A = torch.diag(torch.arange(1.0, 5.0, **f64))

    def fg(x):
        return 0.5 * x @ A @ x, A @ x, {}

    init, step = make_lbfgs_iter(fg, n=4, lower=-torch.ones(4, **f64),
                                 upper=torch.ones(4, **f64))
    x = torch.full((4,), 0.5, **f64)
    st, (f, g, aux) = init(x), fg(x)
    for _ in range(3):
        x, st, f, g, aux, _alpha, _nfev = step(x, st, f, g, aux)
    p = torch.zeros(4, requires_grad=True, **f64)
    opt = torch.optim.Adam([p])
    p.grad = torch.ones_like(p)
    opt.step()
    torch.cuda.synchronize()


def optimizer_paths(cz_problem, ens_problem, dev):
    """Phase ``optimizers``: each optimizer backend through ``optimize`` on
    the card, every run counted (launches = evaluations).  On the CZ: ten
    iterations of ``"lbfgsb"``, ``"scipy-lbfgsb"`` and ``"device-lbfgs"`` at
    one and at five iterations a chunk, five of ``torch.optim.Adam``; on the
    8 x 4 ensemble and the 1024 qutrits the host loop against the device
    loop; one fg at each host run's last pulse; the backend ``"auto"``
    takes on each cell; both loops on the 8 x 4 traced with
    ``profile_dir``.  Returns the phase's record."""
    import functools
    import shutil

    import grape_tpu_torch as gt
    from grape_tpu_torch.optimize import _get_optimizer
    from grape_tpu_torch.optimizers.device_loop import DeviceLoopBackend
    from grape_tpu_torch.optimizers.lbfgsb import LBFGSB
    from grape_tpu_torch.workspace import GrapeWrk

    t_phase = time.perf_counter()
    warm_optimizer_code(dev)
    cells = optimizer_cells(cz_problem, ens_problem)
    out = {"iterations": OPT_ITERS, "cells": {}}
    lbfgs_type = []
    for name, cell in cells.items():
        # the native L-BFGS-B by name: built on the card's host, no scipy
        # stand-in
        runs = {"lbfgsb": backend_run(cell, "lbfgsb", OPT_ITERS, "LBFGSB",
                                      time_final=True)}
        for n in (DEVICE_CHUNKS if name == "cz" else DEVICE_CHUNKS[1:]):
            runs[f"device_lbfgs_chunk{n}"] = backend_run(
                cell, "device-lbfgs", OPT_ITERS, "DeviceLoopBackend",
                device_loop_iters=n)
        if name == "cz":
            runs["scipy_lbfgsb"] = backend_run(
                cell, "scipy-lbfgsb", OPT_ITERS, "ScipyLBFGSB")
            run = backend_run(
                cell, functools.partial(torch.optim.Adam, lr=ADAM_LR),
                ADAM_ITERS, "TorchOptimBackend")
            require(run["J_T_series"][-1] < run["J_T_series"][0],
                    f"Adam on the CZ: {run['J_T_series']}")
            runs["torch_optim_adam"] = run
            a = np.asarray(runs["device_lbfgs_chunk1"]["J_T_series"])
            b = np.asarray(runs["device_lbfgs_chunk5"]["J_T_series"])
            rel = float(np.max(np.abs(a - b) / np.abs(a)))
            out["chunk1_vs_chunk5_max_rel"] = rel
            require(rel <= TOL_CHUNK_SERIES,
                    f"device loop: chunk 1 vs 5 J_T series differ by {rel}")
        for key, run in runs.items():
            if key != "torch_optim_adam":
                lbfgs_type.append((name, key, run["J_T_series"]))
        # the backend "auto" takes on the card: the host loop, by the
        # decision these runs measure (optimize._get_optimizer)
        wrk = GrapeWrk(cell[0], cell[1],
                       dict(cell[2], dtype=np.complex64))
        auto = _get_optimizer(wrk)
        require(wrk.cp.device.type == "cuda" and isinstance(auto, LBFGSB),
                f"auto on {name} took {type(auto).__name__}, not the host "
                "loop")
        host, dev_run = runs["lbfgsb"], runs["device_lbfgs_chunk5"]
        out["cells"][name] = {
            "runs": runs, "auto_backend": type(auto).__name__,
            "device_vs_host": {
                "steady_ms_per_fg": dev_run["steady_ms_per_fg"]
                / host["steady_ms_per_fg"],
                "steady_ms_per_fg_at_guess_squarings":
                    dev_run["steady_ms_per_fg_at_guess_squarings"]
                    / host["steady_ms_per_fg_at_guess_squarings"],
                "steady_iters_per_second": dev_run["steady_iters_per_second"]
                / host["steady_iters_per_second"],
                "J_T_after": [host["J_T_series"][-1],
                              dev_run["J_T_series"][-1]]}}
        del wrk
    for name, key, series in lbfgs_type:
        require(series[-1] < series[0]
                and all(b < a for a, b in zip(series, series[1:])),
                f"{key} on {name}: J_T does not fall monotonically: {series}")

    # both loops on the 8 x 4 ensemble under the profiler
    trajs, tlist, kw, _ = cells["ensemble_8x4"]
    root = os.path.join(HERE, "build", "chip_smoke_optimizers_profile")
    shutil.rmtree(root, ignore_errors=True)
    traced = {}
    for key, optimizer in (("host_loop", "lbfgsb"),
                           ("device_loop", DeviceLoopBackend(
                               chunk_iters=PROFILE_ITERS))):
        trace_dir = os.path.join(root, key)
        t0 = time.perf_counter()
        res = gt.optimize(trajs, tlist, iter_stop=PROFILE_ITERS,
                          dtype=np.complex64, optimizer=optimizer,
                          print_iters=False, rethrow_exceptions=True,
                          profile_dir=trace_dir, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        require(res.iter == PROFILE_ITERS, f"profiled {key}: {res.message}")
        traced[key] = {"seconds_with_trace": secs, "fg_calls": res.fg_calls,
                       "f_calls": res.f_calls,
                       **trace_summary(trace_dir, host=True)}
    shutil.rmtree(root, ignore_errors=True)
    out["profile_ensemble_8x4"] = traced
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "optimizers", **out})
    return out


# ---- phase parallel: trajectory sharding over torch.distributed ----------

PAR_WORLD = 2          # ranks of the two-rank world, both on cuda:0
PAR_ITERS = 3          # optimize(mesh=...) iterations, host and device loop
PAR_TIMEOUT_S = 600    # the ranks' limit, rendezvous to their last output
# the kernels an evaluation of each cell launches once on every rank
PAR_EXPECT = {
    "ensemble_8x4": ("forward_scan_grouped", "chi_scan_grouped",
                     "frechet_trace_pertraj_factored"),
    "cz": ("forward_scan_shared", "chi_scan_shared",
           "frechet_trace_shared_factored"),
}
# a sharded J_T series against the single-process one, relative: the
# gradients differ by the order of float32 sums over K (one rank's rows,
# then the ranks in float64), which three L-BFGS steps carry into J_T
TOL_PAR_SERIES = 1e-4
# weak scaling on the card: 64 transmons of 10 levels a rank, 400 steps
PAR_SCALING = dict(traj_per_device=64, dim=10, n_steps=400, n_iter=3)


def _par_cells(cz_problem, ens_problem):
    return {"ensemble_8x4": ens_problem, "cz": cz_problem}


def _par_compile(problem):
    import grape_tpu_torch as gt

    return gt.compile_problem(problem.trajectories, problem.tlist,
                              dtype=np.complex64, **problem.kwargs)


def _par_series(problem, **kw):
    """The J_T series of ``PAR_ITERS`` iterations of ``optimize``."""
    import grape_tpu_torch as gt

    series = []
    res = gt.optimize(problem.trajectories, problem.tlist,
                      iter_stop=PAR_ITERS, dtype=np.complex64,
                      print_iters=False, rethrow_exceptions=True,
                      callback=lambda w, i: series.append(
                          float(w.result.J_T)),
                      **problem.kwargs, **kw)
    require(res.iter == PAR_ITERS and len(series) == PAR_ITERS + 1,
            f"optimize {kw}: {res.message}")
    return series


def _par_fg_reading(fg, x, expect):
    """One counted evaluation (after a warm one): ``(J, g, launches,
    routes)``, the launches of ``expect`` required to be one each and every
    other wrapper's zero; then the ms of an evaluation (median of 3)."""
    from grape_tpu_torch.ops import hopper_cheby, hopper_frechet, hopper_prop

    mods = (hopper_prop, hopper_frechet, hopper_cheby)
    fg(x)
    torch.cuda.synchronize()
    zero_counts(*mods)
    J, g, aux = fg(x)
    torch.cuda.synchronize()
    counts, routes = read_launches(*mods)
    want = {k: int(k in expect) for k in counts}
    require(counts == want, f"launches of one evaluation {counts}, "
            f"expected {want}")
    require(math.isfinite(float(J)) and bool(torch.isfinite(g).all())
            and bool(aux["taylor_ok"]) and bool(aux["chi_ok"]),
            "sharded evaluation is not finite")
    ms = sorted(timed_ms(lambda: float(fg(x)[0]), 1) for _ in range(3))[1]
    return (float(J), g.double().cpu().numpy(), {k: v for k, v in
                                                  counts.items() if v},
            {k: v for k, v in routes.items() if v}, ms)


def parallel_rank(rank, world, store, out_path):
    """One rank of the two-rank world (``chip_smoke.py --parallel-rank``):
    both ranks on ``cuda:0``, reducing over gloo.  Writes its readings as
    JSON to ``out_path``."""
    rank, world = int(rank), int(world)
    import grape_tpu_torch as gt
    from grape_tpu_torch import parallel
    from grape_tpu_torch.models import (
        two_transmon_cz_ensemble_problem, two_transmon_cz_problem,
    )
    from grape_tpu_torch.ops import _build
    from grape_tpu_torch.parallel.scaling import measure_weak_scaling

    _build.load_kernels()
    parallel.init_distributed(f"file://{store}", world, rank,
                              backend="gloo", timeout=PAR_TIMEOUT_S)
    mesh = parallel.make_mesh()
    cells = _par_cells(
        two_transmon_cz_problem(d=D_TRANSMON, n_steps=N_STEPS),
        two_transmon_cz_ensemble_problem(n_samples=N_SAMPLES, d=D_TRANSMON,
                                         n_steps=N_STEPS))
    out = {"rank": rank, "device": str(torch.cuda.current_device()),
           "backend": torch.distributed.get_backend(), "fg": {},
           "optimize": {}}
    for name, problem in cells.items():
        cp = _par_compile(problem)
        fg, blk = parallel.build_fg_sharded(cp, mesh)
        x = torch.as_tensor(cp.guess_pulsevals.reshape(-1), device=cp.device)
        J, g, counts, routes, ms = _par_fg_reading(fg, x, PAR_EXPECT[name])
        out["fg"][name] = {"J": J, "g": g.tolist(), "launches": counts,
                           "routes": routes, "ms_per_eval": ms,
                           "rows": list(blk.traj_rows),
                           "operator_entries": int(blk.H0.shape[0])}
        out["optimize"][name] = _par_series(problem, mesh=mesh)
    out["device_loop"] = _par_series(
        cells["ensemble_8x4"], mesh=mesh, optimizer="device-lbfgs",
        device_loop_iters=PAR_ITERS)
    out["scaling"] = measure_weak_scaling(n_devices_list=(1, world),
                                          **PAR_SCALING)
    with open(out_path, "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()
    return 0


def _par_spawn(root):
    """Run the two ranks as subprocesses of this script; every rank's
    failure fails the phase, and no rank outlives it."""
    store = os.path.join(root, "store2")
    outs = [os.path.join(root, f"rank{r}.json") for r in range(PAR_WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--parallel-rank",
         str(r), str(PAR_WORLD), store, outs[r]], cwd=HERE,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(PAR_WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=PAR_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        require(p.returncode == 0,
                f"parallel rank {r} exited {p.returncode}:\n{log[-6000:]}")
    ranks = []
    for path in outs:
        with open(path) as f:
            ranks.append(json.load(f))
    return ranks


def parallel_paths(cz_problem, ens_problem, smi):
    """Phase ``parallel``: ``grape_tpu_torch.parallel`` on the card.
    (a) A world of one on NCCL: ``build_fg_sharded`` on the 8 x 4 ensemble
    at full width against ``build_fg`` (equal, bit for bit), K4, K6 and
    the grouped chi scan once per evaluation.  (b) Two ranks as
    subprocesses, both on ``cuda:0`` and reducing over gloo: the ensemble
    (4 groups a rank) and the CZ (2 basis states a rank) against the
    single-process ``fg`` within twice the kernels' own distance from their
    plain versions, three iterations of ``optimize(mesh=...)`` and one
    device-loop chunk with both ranks' J_T series equal bit for bit and
    within ``TOL_PAR_SERIES`` of the single-process series.  (c)
    ``measure_weak_scaling``'s rows for both worlds.  Two ranks sharing one
    card is no scaling number.  Returns the launches of (a)."""
    import shutil

    import grape_tpu_torch as gt
    from grape_tpu_torch import parallel
    from grape_tpu_torch.ops import plain_versions
    from grape_tpu_torch.parallel.scaling import measure_weak_scaling

    t_phase = time.perf_counter()
    root = os.path.join(HERE, "build", "chip_smoke_parallel")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    cells = _par_cells(cz_problem, ens_problem)
    single = {}
    for name, problem in cells.items():
        cp = _par_compile(problem)
        fg = gt.build_fg(cp)
        x = torch.as_tensor(cp.guess_pulsevals.reshape(-1), device=cp.device)
        J, g, counts, routes, ms = _par_fg_reading(fg, x, PAR_EXPECT[name])
        with plain_versions():
            J_p, g_p, _ = fg(x)
        g_p = g_p.double().cpu().numpy()
        single[name] = {
            "cp": cp, "x": x, "J": J, "g": g, "ms_per_eval": ms,
            # the float32 spread: twice the kernels' distance from their
            # plain versions on the same pulse
            "tol_J": max(2 * abs(J - float(J_p)), 1e-6),
            "tol_g": max(2 * float(np.max(np.abs(g - g_p))),
                         1e-6 * float(np.max(np.abs(g)))),
            "series": _par_series(problem)}
    single["ensemble_8x4"]["device_loop"] = _par_series(
        ens_problem, optimizer="device-lbfgs", device_loop_iters=PAR_ITERS)

    # (a) a world of one on NCCL, in this process
    world_size = parallel.init_distributed(f"file://{root}/store1", 1, 0,
                                           timeout=PAR_TIMEOUT_S)
    try:
        backend = torch.distributed.get_backend()
        require(world_size == 1 and backend == "nccl",
                f"world of one on {backend}, size {world_size}")
        mesh = parallel.make_mesh()
        s = single["ensemble_8x4"]
        fg_s, blk = parallel.build_fg_sharded(s["cp"], mesh)
        J, g, counts_one, routes_one, ms = _par_fg_reading(
            fg_s, s["x"], PAR_EXPECT["ensemble_8x4"])
        one = {"backend": backend, "J": J, "J_diff": abs(J - s["J"]),
               "grad_max_abs_diff": float(np.max(np.abs(g - s["g"]))),
               "launches_per_eval": counts_one, "routes": routes_one,
               "ms_per_eval": ms, "ms_per_eval_unsharded": s["ms_per_eval"],
               "scaling": measure_weak_scaling(n_devices_list=(1,),
                                               **PAR_SCALING)}
        require(one["J_diff"] <= s["tol_J"]
                and one["grad_max_abs_diff"] <= s["tol_g"],
                f"world of one against build_fg: {one}")
    finally:
        torch.distributed.destroy_process_group()

    # (b) two ranks on the one card
    t0 = time.perf_counter()
    ranks = _par_spawn(root)
    two = {"seconds": time.perf_counter() - t0,
           "backend": ranks[0]["backend"], "cells": {}}
    for name, s in single.items():
        fgs = [r["fg"][name] for r in ranks]
        g = np.asarray(fgs[0]["g"])
        require(all(f["J"] == fgs[0]["J"] and f["g"] == fgs[0]["g"]
                    for f in fgs), f"{name}: the ranks' (J, grad) differ")
        series = [r["optimize"][name] for r in ranks]
        require(all(t == series[0] for t in series),
                f"{name}: the ranks' J_T series differ: {series}")
        cell = {
            "J": fgs[0]["J"], "J_single": s["J"],
            "J_diff": abs(fgs[0]["J"] - s["J"]), "tol_J": s["tol_J"],
            "grad_max_abs_diff": float(np.max(np.abs(g - s["g"]))),
            "tol_grad": s["tol_g"],
            "J_T_series": series[0], "J_T_series_single": s["series"],
            "series_max_rel_diff": float(np.max(
                np.abs(np.asarray(series[0]) - s["series"])
                / np.abs(s["series"]))),
            "ms_per_eval_by_rank": [f["ms_per_eval"] for f in fgs],
            "ms_per_eval_unsharded": s["ms_per_eval"],
            "launches_per_eval_by_rank": [f["launches"] for f in fgs],
            "routes_by_rank": [f["routes"] for f in fgs],
            "rows_by_rank": [f["rows"] for f in fgs],
            "operator_entries_by_rank": [f["operator_entries"]
                                         for f in fgs]}
        require(cell["J_diff"] <= s["tol_J"]
                and cell["grad_max_abs_diff"] <= s["tol_g"]
                and cell["series_max_rel_diff"] <= TOL_PAR_SERIES,
                f"{name}: two ranks against one process: {cell}")
        two["cells"][name] = cell
    loops = [r["device_loop"] for r in ranks]
    ref = single["ensemble_8x4"]["device_loop"]
    two["device_loop_ensemble_8x4"] = {
        "J_T_series": loops[0], "J_T_series_single": ref,
        "series_max_rel_diff": float(np.max(
            np.abs(np.asarray(loops[0]) - ref) / np.abs(ref)))}
    require(all(t == loops[0] for t in loops)
            and two["device_loop_ensemble_8x4"]["series_max_rel_diff"]
            <= TOL_PAR_SERIES,
            f"device loop under the mesh: {two['device_loop_ensemble_8x4']}")
    two["scaling_by_rank"] = [r["scaling"] for r in ranks]
    shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "parallel", "nvidia_smi": smi,
          "note": "two ranks share one card and reduce through the host "
                  "(gloo): these times are no scaling number",
          "world_of_one": one, "two_ranks": two,
          "seconds": time.perf_counter() - t_phase})
    return counts_one


# ---- the letter, the examples, the keywords ------------------------------

# BASELINE config 5 at the letter (experiments/r5_flagship_ensemble.py):
# 1024 samples of the CZ at dim 100, K = 4096 in 1024 groups of 4, N_T =
# 2000, recompute storage (the segment rule's 40 segments of 50 steps),
# gradgen, complex64, bounds +-0.5 (whose caps are the workspace's envelope)
LETTER_SAMPLES = 1024
LETTER_CALLS = 4
LETTER_ITERS = 3
LETTER_BOUND = 0.5
LETTER_SEGMENTS = 40
# multicall against one call: the same launches in the same order, so the
# same bits are expected; the bound taken if not (stated before the first
# run): recompute against full storage's limits
TOL_LETTER_J, TOL_LETTER_GRAD = 1e-6, 1e-4
# groups of the letter's segment held against the plain versions: the
# first and the last, whose items sit past 2**31 bytes into the U stream
LETTER_CHECK_GROUPS = ((0, 8), (1016, 1024))


def letter_kernel_check(cp, amp_max, dev):
    """K4, the grouped chi scan and K6 at the letter's segment shape (d =
    100, G = 1024 groups of 4, a 50-step window; a U stream of 4.1 GB)
    against their plain versions on the first and last 8 groups (groups
    are independent), and their times there."""
    from grape_tpu_torch.fg import _static_squarings
    from grape_tpu_torch.ops import hopper_frechet as hf
    from grape_tpu_torch.ops import hopper_prop as hp
    from grape_tpu_torch.ops import plain_versions

    c64 = lambda x: torch.tensor(x, dtype=torch.complex64, device=dev)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    seg = cp.n_timesteps // cp.storage_segments
    s = _static_squarings(cp, amp_max)
    H0g, opsg = c64(cp.H0), c64(cp.ops)
    G, gs, d = H0g.shape[0], cp.gen_group_size, cp.dim
    rng = np.random.default_rng(SEED)
    eps = cp.guess_pulsevals[:, :seg] + 0.02 * rng.normal(
        size=(cp.n_controls, seg))
    coeffs = f32(np.einsum("ntl,ln->nt", cp.M[:seg], eps) + cp.Mfix[:seg])
    dts = f32(np.diff(cp.tlist)[:seg])
    psi0 = c64(cp.psi0)
    chi0 = rng.normal(size=psi0.shape) + 1j * rng.normal(size=psi0.shape)
    chi0 = c64(chi0 / np.linalg.norm(chi0, axis=1, keepdims=True))
    st, U = hp.forward_scan_grouped(H0g, opsg, coeffs, dts, psi0, gs, s)
    chis = hp.chi_scan_grouped(U, chi0)
    psis = st[:-1].contiguous()
    trj = hf.frechet_trace_pertraj(H0g, opsg, coeffs, dts, psis, chis, s,
                                   group_size=gs)
    torch.cuda.synchronize()
    require(finite(st, U, chis, trj), "a letter kernel output is not finite")
    err = dict.fromkeys(("forward_scan_grouped", "chi_scan_grouped",
                         "frechet_trace_pertraj_factored"), 0.0)
    for g0, g1 in LETTER_CHECK_GROUPS:
        k0, k1 = g0 * gs, g1 * gs
        with plain_versions():
            st_p, U_p = hp.forward_scan_grouped(
                H0g[g0:g1].contiguous(), opsg[g0:g1].contiguous(), coeffs,
                dts, psi0[k0:k1].contiguous(), gs, s)
            chis_p = hp.chi_scan_grouped(U[:, g0:g1].contiguous(),
                                         chi0[k0:k1].contiguous())
            trj_p = hf.frechet_trace_pertraj(
                H0g[g0:g1].contiguous(), opsg[g0:g1].contiguous(), coeffs,
                dts, psis[:, k0:k1].contiguous(),
                chis[:, k0:k1].contiguous(), s, group_size=gs)
        torch.cuda.synchronize()
        scale = max(float(trj_p.abs().max()), 1.0)
        e = {"forward_scan_grouped": max(max_abs(st[:, k0:k1], st_p),
                                         max_abs(U[:, g0:g1], U_p)),
             "chi_scan_grouped": max_abs(chis[:, k0:k1], chis_p),
             "frechet_trace_pertraj_factored":
                 max_abs(trj[:, k0:k1], trj_p) / scale}
        for name, val in e.items():
            tol = TOL_TRJ if name.startswith("frechet") else TOL_STATE
            require(val < tol, f"{name} disagrees with its plain version "
                    f"on groups {g0}..{g1} of the letter: {val} ({tol})")
            err[name] = max(err[name], val)
    ms = {
        "forward_scan_grouped": median_ms(lambda: hp.forward_scan_grouped(
            H0g, opsg, coeffs, dts, psi0, gs, s), reps=3),
        "chi_scan_grouped": median_ms(
            lambda: hp.chi_scan_grouped(U, chi0), reps=3),
        "frechet_trace_pertraj_factored": median_ms(
            lambda: hf.frechet_trace_pertraj(H0g, opsg, coeffs, dts, psis,
                                             chis, s, group_size=gs),
            reps=3),
    }
    out = {"shape": {"d": d, "G": G, "gs": gs, "K": G * gs, "N_T": seg,
                     "T": opsg.shape[1], "s": s},
           "u_stream_bytes": nbytes(U), "checked_groups": LETTER_CHECK_GROUPS,
           "max_abs_err": err, "ms": ms}
    del st, U, chis, psis, trj, H0g, opsg, psi0, chi0
    torch.cuda.empty_cache()
    return out


def letter_paths(dev):
    """Phase ``letter``: BASELINE config 5 at the letter through
    ``build_fg`` and ``build_fg_multicall(n_calls=4)`` (one evaluation each
    at the guess, then the one-call build's timed again: the same J and
    gradient, ms an evaluation, peak memory, launches an evaluation), the
    kernels at its segment shape against their plain versions, and
    ``LETTER_ITERS`` iterations of ``optimize_problem(...,
    eval_device_calls=4)`` with J_T falling.  Returns the launch counts of
    its evaluations and the kernels' readings at the segment shape."""
    import grape_tpu_torch as gt
    from grape_tpu_torch.fg import (
        _seg_reuse_U, _vec_gradgen_enabled, build_fg_multicall,
    )
    from grape_tpu_torch.models import two_transmon_cz_ensemble_problem
    from grape_tpu_torch.ops import (
        hopper_cheby, hopper_frechet, hopper_matmul, hopper_prop,
    )

    mods = (hopper_prop, hopper_frechet, hopper_cheby, hopper_matmul)
    t_phase = time.perf_counter()
    kw = dict(dtype=np.complex64, storage_mode="recompute",
              gradient_method="gradgen")
    problem = two_transmon_cz_ensemble_problem(
        n_samples=LETTER_SAMPLES, d=D_TRANSMON, n_steps=N_STEPS)
    t0 = time.perf_counter()
    cp = gt.compile_problem(problem.trajectories, problem.tlist, **kw,
                            **problem.kwargs)
    compile_s = time.perf_counter() - t0
    S = cp.storage_segments
    seg_u_bytes = ((cp.n_timesteps // S) * cp.H0.shape[0] * cp.dim ** 2
                   * np.dtype(cp.psi0.dtype).itemsize)
    require(S == LETTER_SEGMENTS and cp.n_traj == 4 * LETTER_SAMPLES
            and cp.ops_grouped and cp.gen_group_size == 4
            and cp.H0.shape[0] == LETTER_SAMPLES
            and _vec_gradgen_enabled(cp), "unexpected letter routing")
    amp_max = np.full(cp.n_controls, LETTER_BOUND)
    seg = cp.n_timesteps // S
    windows = -(-seg // hopper_prop._window_steps(cp.H0.shape[0], cp.dim,
                                                  seg))
    check = letter_kernel_check(cp, amp_max, dev)

    x0 = cp.guess_pulsevals.reshape(-1)
    fgs = {1: gt.build_fg(cp, amp_max=amp_max),
           LETTER_CALLS: build_fg_multicall(cp, amp_max=amp_max,
                                            n_calls=LETTER_CALLS)}
    res_by_calls, per_eval = {}, {}
    counts_all = None
    for calls, fg in fgs.items():
        zero_counts(*mods)
        (J, g, aux), peak, first_ms = _peak_bytes(lambda: fg(x0))
        counts, routes = read_launches(*mods)
        ROUTE_READS.append((f"letter_calls_{calls}", routes))
        counts_all = counts if counts_all is None else {
            k: counts_all[k] + counts[k] for k in counts}
        require(math.isfinite(float(J)) and bool(torch.isfinite(g).all())
                and bool(aux["chi_ok"]),
                f"letter, {calls} calls: not finite")
        expect = dict.fromkeys(counts, 0)
        expect.update({"forward_scan_grouped": 2 * S, "chi_scan_grouped": S,
                       "frechet_trace_pertraj_factored": S})
        require(counts == expect, f"letter launches, {calls} calls: "
                f"{counts}, expected {expect}")
        # a forward segment without its U stream forms the propagators in
        # windows (hopper_prop._window_steps), a scan each; the recomputed
        # segment keeps its stream: one launch
        expect_routes = dict.fromkeys(routes, 0)
        expect_routes.update({"propagators_cluster": S * (1 + windows),
                              "state_scan_forward": S * (1 + windows),
                              "state_scan_chi": S})
        require(routes == expect_routes, f"letter routes, {calls} calls: "
                f"{routes}, expected {expect_routes}")
        res_by_calls[calls] = (float(J), g)
        per_eval[calls] = {"first_ms": first_ms, "peak_bytes": peak,
                           "launches": {k: v for k, v in counts.items()
                                        if v},
                           "route_launches": {k: v for k, v in
                                              routes.items() if v}}
        del aux
    # the multicall evaluation above ran on a warm allocator; so does this
    # second evaluation in one call (the first grew the allocator)
    per_eval[1]["ms_per_eval"] = timed_ms(lambda: fgs[1](x0), 1)
    per_eval[LETTER_CALLS]["ms_per_eval"] = per_eval[LETTER_CALLS][
        "first_ms"]
    del fgs
    torch.cuda.empty_cache()
    (J1, g1), (J4, g4) = res_by_calls[1], res_by_calls[LETTER_CALLS]
    bits = J1 == J4 and bool(torch.equal(g1, g4))
    dJ = abs(J1 - J4)
    dg = max_abs(g1, g4) / float(g1.abs().max())
    require(dJ <= TOL_LETTER_J and dg <= TOL_LETTER_GRAD,
            f"letter: {LETTER_CALLS} calls against one: dJ {dJ}, dgrad {dg}")
    del res_by_calls, g1, g4

    # LETTER_ITERS iterations of the solve, the host loop ("auto")
    series = []
    zero_counts(*mods)
    t0 = time.perf_counter()
    res = gt.optimize_problem(
        problem, iter_stop=LETTER_ITERS, print_iters=False,
        rethrow_exceptions=True, eval_device_calls=LETTER_CALLS,
        lower_bound=-LETTER_BOUND, upper_bound=LETTER_BOUND, **kw,
        callback=lambda wrk, it: series.append(float(wrk.result.J_T)))
    opt_s = time.perf_counter() - t0
    counts_opt = read_counts(*mods)
    expect = dict.fromkeys(counts_opt, 0)
    expect.update({
        "forward_scan_grouped": S * (2 * res.fg_calls + res.f_calls),
        "chi_scan_grouped": S * res.fg_calls,
        "frechet_trace_pertraj_factored": S * res.fg_calls})
    require(counts_opt == expect, f"letter optimize launches {counts_opt}, "
            f"expected {expect}")
    require(len(series) == LETTER_ITERS + 1 and series[-1] < series[0]
            and all(b <= a for a, b in zip(series, series[1:])),
            f"letter: J_T does not fall: {series}")
    counts_all = {k: counts_all[k] + counts_opt[k] for k in counts_all}
    emit({"phase": "letter", "samples": LETTER_SAMPLES, "K": cp.n_traj,
          "dim": cp.dim, "N_T": cp.n_timesteps, "segments": S,
          "segment_steps": seg, "n_calls": LETTER_CALLS,
          "forward_windows_per_segment": windows,
          "compile_problem_seconds": compile_s,
          "segment_u_bytes": seg_u_bytes,
          "seg_reuse_U": bool(_seg_reuse_U(cp)),
          "seg_reuse_U_limit_bytes": 4 * 1024 ** 3,
          "J": J1, "bit_for_bit": bits, "J_abs_diff": dJ,
          "grad_diff_of_max": dg,
          "tol": {"J": TOL_LETTER_J, "grad_of_max": TOL_LETTER_GRAD},
          "one_call": per_eval[1], "multicall": per_eval[LETTER_CALLS],
          "flop_rate": flop_rate(cp, per_eval[1]["ms_per_eval"]),
          "kernels_at_segment": check,
          "optimize": {"J_T_series": series, "iterations": res.iter,
                       "seconds": opt_s, "fg_calls": res.fg_calls,
                       "f_calls": res.f_calls, "message": res.message,
                       "launches": {k: v for k, v in counts_opt.items()
                                    if v}},
          "seconds": time.perf_counter() - t_phase})
    return counts_all, check


# the port's examples (grape_tpu_torch/examples), each main with its own
# settings and assertions; the tutorial with the budget of its test
EXAMPLE_MAINS = (
    ("tls_state_transfer", "main", {}),
    ("stirap_guard_penalty", "main", {}),
    ("robust_ensemble", "main", {}),
    ("robust_ensemble", "main_robust_gate", {}),
    ("xgate_observables", "main", {}),
    ("nonlinear_amplitude", "main", {}),
    ("subspace_gate_fat_batch", "main", {}),
    ("krotov_continuation", "main", {}),
    ("tutorial", "main", {"iter_stop": 3, "converged_below": 0.5}),
)


def example_paths():
    """Phase ``examples``: each example's ``main`` on the card in complex64
    (its printout kept out of this script's output), its own assertions,
    the kernels it launched; where an assertion fails in complex64, the
    failure is recorded and the example runs again in complex128, which
    must pass.  Returns the launches of the complex64 runs together."""
    import contextlib
    import importlib
    import io

    from grape_tpu_torch.ops import (
        hopper_cheby, hopper_frechet, hopper_matmul, hopper_prop,
    )

    mods = (hopper_prop, hopper_frechet, hopper_cheby, hopper_matmul)
    rows, total = [], {}
    t_phase = time.perf_counter()
    for module, name, extra in EXAMPLE_MAINS:
        main_fn = getattr(importlib.import_module(
            f"grape_tpu_torch.examples.{module}"), name)
        row = {"example": f"{module}.{name}"}
        for dtype in (np.complex64, np.complex128):
            zero_counts(*mods)
            buf = io.StringIO()
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(buf):
                    res = main_fn(dtype=dtype, **extra)
            except AssertionError as exc:
                require(dtype == np.complex64,
                        f"{module}.{name} fails in complex128: {exc}")
                row["complex64_assertion"] = str(exc) or "assert"
                continue
            counts, routes = read_launches(*mods)
            ROUTE_READS.append((f"example_{module}_{name}", routes))
            if dtype == np.complex64:
                for k, v in counts.items():
                    total[k] = total.get(k, 0) + v
            row.update({
                "dtype": np.dtype(dtype).name, "J_T": float(res.J_T),
                "iterations": res.iter, "fg_calls": res.fg_calls,
                "seconds": time.perf_counter() - t0,
                "printed_lines": len(buf.getvalue().splitlines()),
                "launches": {k: v for k, v in counts.items() if v},
                "route_launches": {k: v for k, v in routes.items() if v}})
            break
        require(math.isfinite(row["J_T"]), f"{module}.{name}: J_T")
        rows.append(row)
    emit({"phase": "examples", "rows": rows,
          "seconds": time.perf_counter() - t_phase})
    return total


def keyword_paths(cz_problem, dev):
    """Phase ``keywords`` on the CZ (dim 100, K = 4, N_T = 2000): the
    default build against ``use_pallas=False`` (no hand-written kernel
    launched, every route count 0; J and gradient within the kernels-vs-
    plain limits; ms an evaluation of each), the three values of
    ``gradgen_pallas_precision`` (the same bits) and ``prewarm_envelope``
    True / False (the same J_T series over 2 iterations)."""
    import grape_tpu_torch as gt
    from grape_tpu_torch.ops import (
        hopper_cheby, hopper_frechet, hopper_matmul, hopper_prop,
    )

    mods = (hopper_prop, hopper_frechet, hopper_cheby, hopper_matmul)
    t_phase = time.perf_counter()

    def build(**kw):
        cp = gt.compile_problem(cz_problem.trajectories, cz_problem.tlist,
                                dtype=np.complex64, **cz_problem.kwargs, **kw)
        return cp, gt.build_fg(cp)

    cp, fg = build()
    x0 = cp.guess_pulsevals.reshape(-1)
    J, g, _ = fg(x0)
    ms_default = timed_ms(lambda: fg(x0), 3)
    _, fg_x = build(use_pallas=False)
    zero_counts(*mods)
    J_x, g_x, aux_x = fg_x(x0)
    torch.cuda.synchronize()
    counts, routes = read_launches(*mods)
    require(not any(counts.values()) and not any(routes.values()),
            f"use_pallas=False launched a kernel: {counts} {routes}")
    ms_plain = timed_ms(lambda: fg_x(x0), 2)
    dJ = abs(float(J) - float(J_x))
    dg = max_abs(g, g_x) / float(g.abs().max())
    require(dJ < 1e-5 and dg < 2e-3 and bool(aux_x["chi_ok"]),
            f"use_pallas=False against the kernels: dJ {dJ}, dgrad {dg}")
    same = {}
    for prec in ("high", "highest", "default"):
        _, fg_p = build(gradgen_pallas_precision=prec)
        J_p, g_p, _ = fg_p(x0)
        same[prec] = float(J_p) == float(J) and bool(torch.equal(g_p, g))
    require(all(same.values()), f"precision values differ: {same}")
    series = {}
    for prewarm in (True, False):
        tr = []
        gt.optimize_problem(
            cz_problem, iter_stop=2, print_iters=False, dtype=np.complex64,
            rethrow_exceptions=True, prewarm_envelope=prewarm,
            callback=lambda wrk, it: tr.append(float(wrk.result.J_T)))
        series[str(prewarm)] = tr
    require(series["True"] == series["False"],
            f"prewarm_envelope changes the series: {series}")
    emit({"phase": "keywords", "J": float(J),
          "use_pallas_false": {"J": float(J_x), "J_abs_diff": dJ,
                               "grad_diff_of_max": dg,
                               "launches": sum(counts.values()),
                               "route_launches": sum(routes.values()),
                               "ms_per_eval": ms_plain},
          "ms_per_eval_default": ms_default,
          "precision_same_bits": same,
          "prewarm_envelope_series": series,
          "seconds": time.perf_counter() - t_phase})


def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: "
              "torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if len(sys.argv) > 1 and sys.argv[1] == "--parallel-rank":
        return parallel_rank(*sys.argv[2:])
    only = sys.argv[2] if len(sys.argv) > 2 and sys.argv[1] == "--phase" \
        else None
    require(only in (None, "taylor_order", "cheby"),
            f"unknown phase {only!r}")
    t_start = time.perf_counter()

    import grape_tpu_torch as gt
    from grape_tpu_torch.fg import _static_squarings
    from grape_tpu_torch.functionals import make_ensemble_gate_functional
    from grape_tpu_torch.models import (
        two_transmon_cz_ensemble_problem, two_transmon_cz_problem,
    )
    from grape_tpu_torch.ops import (
        _build, hopper_cheby, hopper_frechet, hopper_prop,
    )
    from grape_tpu_torch.ops import plain_versions
    from grape_tpu_torch.optimizers import lbfgsb

    if os.path.dirname(os.path.abspath(gt.__file__)) != os.path.join(
        HERE, "grape_tpu_torch"
    ):
        raise RuntimeError(
            f"grape_tpu_torch was imported from {gt.__file__}, not from "
            "beside chip_smoke.py"
        )

    # ---- phase 1: device --------------------------------------------------
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # ---- phase 2: build ---------------------------------------------------
    t0 = time.perf_counter()
    _build.load_kernels(verbose=True)  # -Xptxas -v: registers and spills
    kernels_s = time.perf_counter() - t0
    lbfgsb._load()  # the host optimizer (g++), so phase 5 times no build
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels_seconds": kernels_s,
          "rebuilt": _build.last_build["rebuilt"],
          "ptxas": ptxas_summary(_build.last_build["log"]),
          "sources": [os.path.relpath(p, HERE)
                      for p in sum(_build.kernel_sources(), [])]})
    if only is not None:
        rng = np.random.default_rng(SEED)
        if only == "cheby":
            cheby_paths(rng, dev)
        taylor_order_phase(rng, dev)
        emit({"ok": True, "phase_only": only})
        return 0

    # ---- the main path's problem -----------------------------------------
    problem = two_transmon_cz_problem(d=D_TRANSMON, n_steps=N_STEPS)
    cp = gt.compile_problem(
        problem.trajectories, problem.tlist, dtype=np.complex64,
        **problem.kwargs,
    )
    require(cp.device.type == "cuda" and cp.psi0.dtype == np.complex64,
            "the main path must be compiled for CUDA in complex64")
    d, K, N_T = cp.dim, cp.n_traj, cp.n_timesteps
    T, L = cp.ops.shape[1], cp.n_controls
    require((d, K, T, L, N_T) == (100, 4, 4, 4, 2000),
            f"unexpected main-path shape {(d, K, T, L, N_T)}")
    s_cz = _static_squarings(cp)

    # ---- phase 3: each kernel against its plain version -------------------
    rng = np.random.default_rng(SEED)
    c64 = lambda x: torch.tensor(x, dtype=torch.complex64, device=dev)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    H0, ops = c64(cp.H0[0]), c64(cp.ops[0])
    # the guess pulse plus seeded noise on all four controls, as the
    # optimizer's iterates have
    eps = cp.guess_pulsevals + 0.02 * rng.normal(size=(L, N_T))
    coeffs = f32(np.einsum("ntl,ln->nt", cp.M, eps) + cp.Mfix)
    dts = f32(np.diff(cp.tlist))
    psi0 = c64(cp.psi0)
    chi0 = rng.normal(size=(K, d)) + 1j * rng.normal(size=(K, d))
    chi0 = c64(chi0 / np.linalg.norm(chi0, axis=1, keepdims=True))

    err = {"forward_scan_shared": 0.0, "chi_scan_shared": 0.0,
           "frechet_trace_shared": 0.0, "frechet_trace_shared_factored": 0.0}
    checks = []
    for s in sorted({s_cz, 2}):
        require(hopper_frechet.frechet_route(d, T, K, s) == "factored",
                f"the CZ's Frechet traces must take the factored kernel "
                f"at s={s}")
        st, U = hopper_prop.forward_scan_shared(H0, ops, coeffs, dts, psi0, s)
        torch.cuda.synchronize()
        chis = hopper_prop.chi_scan_shared(U, chi0)
        torch.cuda.synchronize()
        psis = st[:-1].contiguous()
        trj = hopper_frechet.frechet_trace_shared(
            H0, ops, coeffs, dts, psis, chis, s
        )
        torch.cuda.synchronize()
        trj_d = frechet_forced("dense", H0, ops, coeffs, dts, psis, chis, s)
        torch.cuda.synchronize()
        with plain_versions():
            st_p, U_p = hopper_prop.forward_scan_shared(
                H0, ops, coeffs, dts, psi0, s
            )
            chis_p = hopper_prop.chi_scan_shared(U, chi0)
            trj_p = hopper_frechet.frechet_trace_shared(
                H0, ops, coeffs, dts, psis, chis, s
            )
            trj_dp = frechet_forced("dense", H0, ops, coeffs, dts, psis,
                                    chis, s)
        torch.cuda.synchronize()
        for x in (st, U, chis, trj, trj_d):
            require(bool(torch.isfinite(torch.view_as_real(x)).all()),
                    f"a kernel output is not finite at s={s}")
        require(st.shape == (N_T + 1, K, d) and U.shape == (N_T, d, d)
                and chis.shape == (N_T, K, d) and trj.shape == (N_T, K, T)
                and trj_d.shape == (N_T, K, T),
                "a kernel output has the wrong shape")
        e_fwd = max(max_abs(st, st_p), max_abs(U, U_p))
        e_chi = max_abs(chis, chis_p)
        scale = max(float(trj_p.abs().max()), 1.0)
        e_trj = max_abs(trj, trj_p)
        e_dense = max_abs(trj_d, trj_dp)
        e_routes = max_abs(trj, trj_d)
        checks.append({"s": s, "forward": e_fwd, "chi": e_chi,
                       "trj_factored": e_trj, "trj_dense": e_dense,
                       "trj_factored_vs_dense": e_routes,
                       "trj_scale": scale,
                       "trj_max": float(trj_p.abs().max())})
        require(e_fwd < TOL_STATE,
                f"forward scan disagrees at s={s}: {e_fwd}")
        require(e_chi < TOL_STATE, f"chi scan disagrees at s={s}: {e_chi}")
        require(e_trj < TOL_TRJ * scale,
                f"factored Frechet trace disagrees at s={s}: {e_trj}")
        require(e_dense < TOL_TRJ * scale,
                f"dense Frechet trace disagrees at s={s}: {e_dense}")
        require(e_routes < TOL_ROUTES * scale,
                f"the two Frechet kernels disagree at s={s}: {e_routes}")
        err["forward_scan_shared"] = max(err["forward_scan_shared"], e_fwd)
        err["chi_scan_shared"] = max(err["chi_scan_shared"], e_chi)
        err["frechet_trace_shared"] = max(err["frechet_trace_shared"],
                                          e_dense)
        err["frechet_trace_shared_factored"] = max(
            err["frechet_trace_shared_factored"], e_trj)
    del trj_d, trj_dp
    emit({"phase": "kernel_check", "shape": {"d": d, "K": K, "T": T,
                                             "N_T": N_T},
          "s_main_path": s_cz, "tol_state": TOL_STATE,
          "tol_trj_of_scale": TOL_TRJ, "tol_routes_of_scale": TOL_ROUTES,
          "checks": checks})

    # other shapes than the main path's: ragged tiles (d not a multiple of
    # 64, d > 128), more trajectories than one scan block holds, one step,
    # tiny d.  The CPU tests cannot reach the CUDA code, so the general
    # shape handling is held against the plain versions here.  At d = 130
    # the dense Frechet kernel is forced (the rule takes the factored one
    # there), so that its ragged third tile stays checked.
    shape_checks = []
    for (d_, K_, T_, N_, s_, h_, route_) in [
            (128, 8, 1, 5, 0, 10.0, None),
            (5, 1, 3, 1, 4, 100.0, None),
            (64, 9, 2, 300, 1, 20.0, None),
            (130, 2, 2, 3, 1, 20.0, "dense"),
            (2, 1, 1, 500, 0, 5.0, None)]:
        Hs = rng.normal(size=(d_, d_)) + 1j * rng.normal(size=(d_, d_))
        Hs = c64(h_ * (Hs + Hs.conj().T) / np.sqrt(d_))
        Os = rng.normal(size=(T_, d_, d_)) + 1j * rng.normal(size=(T_, d_, d_))
        Os = c64((Os + Os.conj().transpose(0, 2, 1)) / np.sqrt(d_))
        cs = f32(0.3 * rng.normal(size=(N_, T_)))
        ts = f32(0.025 * (1 + 0.1 * rng.uniform(size=N_)))
        p0 = rng.normal(size=(K_, d_)) + 1j * rng.normal(size=(K_, d_))
        p0 = c64(p0 / np.linalg.norm(p0, axis=1, keepdims=True))
        x0_ = rng.normal(size=(K_, d_)) + 1j * rng.normal(size=(K_, d_))
        x0_ = c64(x0_ / np.linalg.norm(x0_, axis=1, keepdims=True))
        st, U = hopper_prop.forward_scan_shared(Hs, Os, cs, ts, p0, s_)
        chis = hopper_prop.chi_scan_shared(U, x0_)
        psis = st[:-1].contiguous()
        route_ = route_ or hopper_frechet.frechet_route(d_, T_, K_, s_)
        trj = frechet_forced(route_, Hs, Os, cs, ts, psis, chis, s_)
        torch.cuda.synchronize()
        with plain_versions():
            st_p, U_p = hopper_prop.forward_scan_shared(Hs, Os, cs, ts, p0, s_)
            chis_p = hopper_prop.chi_scan_shared(U, x0_)
            trj_p = frechet_forced(route_, Hs, Os, cs, ts, psis, chis, s_)
        worst = max(max_abs(st, st_p), max_abs(U, U_p),
                    max_abs(chis, chis_p),
                    max_abs(trj, trj_p) / max(float(trj_p.abs().max()), 1.0))
        shape_checks.append({"d": d_, "K": K_, "T": T_, "N_T": N_, "s": s_,
                             "frechet_route": route_,
                             "propagator_route":
                                 hopper_prop.propagator_route(d_),
                             "max_abs_err": worst})
        require(worst < TOL_TRJ, f"kernels disagree with their plain "
                f"versions at shape {shape_checks[-1]}")
    emit({"phase": "kernel_shapes", "tol": TOL_TRJ, "checks": shape_checks})

    # times at the main path's shapes and its squaring count
    s = s_cz
    st, U = hopper_prop.forward_scan_shared(H0, ops, coeffs, dts, psi0, s)
    chis = hopper_prop.chi_scan_shared(U, chi0)
    psis = st[:-1].contiguous()
    trj = hopper_frechet.frechet_trace_shared(
        H0, ops, coeffs, dts, psis, chis, s
    )
    def frechet(route=None, co=coeffs, ts=dts, ps=psis, xs=chis):
        if route is None:
            return lambda: hopper_frechet.frechet_trace_shared(
                H0, ops, co, ts, ps, xs, s)
        return lambda: frechet_forced(route, H0, ops, co, ts, ps, xs, s)

    ms = {
        "forward_scan_shared": median_ms(
            lambda: hopper_prop.forward_scan_shared(
                H0, ops, coeffs, dts, psi0, s)),
        "chi_scan_shared": median_ms(
            lambda: hopper_prop.chi_scan_shared(U, chi0)),
        "frechet_trace_shared_factored": median_ms(frechet()),
        "frechet_trace_shared": median_ms(frechet("dense"), reps=3),
    }
    propagators_ms = median_ms(
        lambda: hopper_prop.propagators_shared(H0, ops, coeffs, dts, s))
    frechet_under_load = under_load(frechet(), 20)
    # is the factored kernel's time linear in the number of (step, group)
    # items?  The same launch on the time grid repeated 2, 4 and 8 times
    # (8 x 2000 steps is the ensemble path's item count), and the 2000
    # items in launches of 400
    frechet_ms_by_steps = {}
    for mult in (1, 2, 4, 8):
        frechet_ms_by_steps[N_T * mult] = median_ms(frechet(
            co=coeffs.repeat(mult, 1), ts=dts.repeat(mult),
            ps=psis.repeat(mult, 1, 1), xs=chis.repeat(mult, 1, 1)), reps=3)
    frechet_ms_by_launch = {
        ("all" if steps == N_T else str(steps)): windowed_ms(
            lambda n0, n1: hopper_frechet.frechet_trace_shared(
                H0, ops, coeffs[n0:n1], dts[n0:n1], psis[n0:n1],
                chis[n0:n1], s), N_T, steps)
        for steps in (400, N_T)}
    with plain_versions():
        plain_ms = {
            "forward_scan_shared": median_ms(
                lambda: hopper_prop.forward_scan_shared(
                    H0, ops, coeffs, dts, psi0, s), reps=3),
            "chi_scan_shared": median_ms(
                lambda: hopper_prop.chi_scan_shared(U, chi0), reps=3),
            "frechet_trace_shared_factored": median_ms(frechet(), reps=3),
            "frechet_trace_shared": median_ms(frechet("dense"), reps=3),
        }
    # yardstick for the propagator half of the forward scan: one library
    # call that computes the same N_T exponentials (never used by the port)
    A_lib = (-1j * dts.to(torch.complex64))[:, None, None] * (
        H0[None] + torch.einsum("nt,tij->nij", coeffs.to(torch.complex64),
                                ops)
    )
    library_ms = median_ms(lambda: torch.linalg.matrix_exp(A_lib), reps=3)
    del A_lib

    cmm = 8.0 * d ** 3  # flops of one complex d x d product (4 mul + 4 add)
    flops = {
        "forward_scan_shared": N_T * ((6 + s) * cmm + 8.0 * K * d * d),
        "chi_scan_shared": (N_T - 1) * 8.0 * K * d * d,
        # one function, one bound, whichever kernel computes it
        "frechet_trace_shared": frechet_needed_flops(d, K, T, N_T, s),
        "frechet_trace_shared_factored": frechet_needed_flops(d, K, T, N_T,
                                                              s),
    }
    # what each Frechet kernel's own algorithm does; reported beside the
    # bound, never used for it
    frechet_algorithm_flops = {
        route: N_T * n for route, n in
        hopper_frechet.frechet_flops(d, T, K, s).items()}
    byts = {
        "forward_scan_shared": nbytes(H0, ops, coeffs, dts, psi0, st, U),
        "chi_scan_shared": nbytes(U, chi0, chis),
        "frechet_trace_shared": nbytes(H0, ops, coeffs, dts, psis, chis,
                                       trj),
    }
    byts["frechet_trace_shared_factored"] = byts["frechet_trace_shared"]

    # ---- the ensemble path's problem and its kernels ----------------------
    ens_problem = two_transmon_cz_ensemble_problem(
        n_samples=N_SAMPLES, d=D_TRANSMON, n_steps=N_STEPS)
    cp_ens = gt.compile_problem(
        ens_problem.trajectories, ens_problem.tlist, dtype=np.complex64,
        **ens_problem.kwargs,
    )
    require((cp_ens.dim, cp_ens.n_traj, cp_ens.H0.shape[0],
             cp_ens.gen_group_size, cp_ens.ops.shape[1], cp_ens.n_controls,
             cp_ens.n_timesteps) == (100, 32, 8, 4, 4, 4, 2000)
            and cp_ens.ops_grouped and not cp_ens.shared_generator,
            "unexpected ensemble-path shape")
    s_ens = _static_squarings(cp_ens)
    ens = ensemble_kernel_phases(cp_ens, s_ens, rng, dev)
    frechet_extension_phase(cp, dev)

    # ---- the two redesigned kernels: routes forced, layouts ---------------
    k_prop, k_wide = prop_routes_phase(cp, cp_ens, s_cz, dev)
    k_scan, k_grid = scan_routes_phase(dev)
    cluster_shapes_phase(dev)
    phase_clock_phase(dev)

    # ---- small-input reference, before the main path is counted ----------
    # the kernel path in complex64 against the plain complex128 path
    # (Padé-13), both on the card, on the d = 3 CZ problem
    small = two_transmon_cz_problem(d=3, n_steps=20, T=5.0)
    cp64 = gt.compile_problem(small.trajectories, small.tlist,
                              dtype=np.complex64, **small.kwargs)
    cp128 = gt.compile_problem(small.trajectories, small.tlist,
                               dtype=np.complex128, **small.kwargs)
    xs = cp64.guess_pulsevals.reshape(-1)
    Js, gs, _ = gt.build_fg(cp64)(xs)
    Jr, gr, _ = gt.build_fg(cp128)(xs)
    dJs = abs(float(Js) - float(Jr))
    dgs = float((gs.double() - gr).abs().max() / gr.abs().max())
    require(dJs < 1e-5 and dgs < 2e-3, f"small CZ: dJ {dJs}, dgrad {dgs}")
    emit({"phase": "fg_small_reference", "J_complex64_kernels": float(Js),
          "J_complex128_plain": float(Jr), "J_abs_diff": dJs,
          "grad_diff_of_max": dgs})

    # ---- the main path: every count set to 0 just before -----------------
    zero_counts(hopper_prop, hopper_frechet, hopper_cheby)

    # ---- phase 4: one fg evaluation through compile_problem / build_fg ----
    fg = gt.build_fg(cp)
    x0 = cp.guess_pulsevals.reshape(-1)
    J, g, aux = fg(x0)
    torch.cuda.synchronize()
    n_fg = 1
    counts_after_one = {
        name: n for name, n in read_counts(hopper_prop,
                                           hopper_frechet).items()
        if name in ("forward_scan_shared", "chi_scan_shared",
                    "frechet_trace_shared_factored")
    }
    require(all(v == 1 for v in counts_after_one.values()),
            f"one fg evaluation did not launch every kernel: "
            f"{counts_after_one}")
    require(g.shape == (L * N_T,) and g.device.type == "cuda"
            and aux["psi_T"].shape == (K, d),
            "fg output has the wrong shape or device")
    require(bool(torch.isfinite(g).all()) and math.isfinite(float(J))
            and bool(aux["chi_ok"]), "fg output is not finite")
    with plain_versions():
        J_p, g_p, _ = fg(x0)
    torch.cuda.synchronize()
    dJ = abs(float(J) - float(J_p))
    dg = max_abs(g, g_p) / float(g_p.abs().max())
    require(dJ < 1e-5, f"fg: J kernels {float(J)} vs plain {float(J_p)}")
    require(dg < 2e-3, f"fg: gradient differs by {dg} of its max")
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        fg(x0)
    torch.cuda.synchronize()
    fg_ms = (time.perf_counter() - t0) / reps * 1e3
    n_fg += reps
    parts = fg_breakdown(fg, x0)
    n_fg += 4
    with plain_versions():
        t0 = time.perf_counter()
        fg(x0)
        torch.cuda.synchronize()
        fg_plain_ms = (time.perf_counter() - t0) * 1e3
    emit({"phase": "fg", "J": float(J), "grad_norm": float(g.norm()),
          "ms_per_eval": fg_ms, "plain_ms_per_eval": fg_plain_ms,
          "flop_rate": flop_rate(cp, fg_ms),
          "device_ms_by_part": parts,
          "J_abs_diff_vs_plain": dJ, "grad_diff_of_max_vs_plain": dg,
          "squarings": s_cz, "dtype": "complex64",
          "launches_after_one_eval": counts_after_one})

    # ---- phase 5: five L-BFGS-B iterations through optimize_problem -------
    series, iter_secs, iter_fg = [], [], []

    def record(wrk, iteration):
        series.append(float(wrk.result.J_T))
        iter_secs.append(float(wrk.result.secs))  # host clock, per iteration
        iter_fg.append(int(wrk.fg_count[0]))

    t0 = time.perf_counter()
    res = gt.optimize_problem(
        problem, iter_stop=ITER_STOP, dtype=np.complex64, print_iters=False,
        rethrow_exceptions=True, callback=record,
    )
    torch.cuda.synchronize()
    opt_s = time.perf_counter() - t0
    require(len(series) == ITER_STOP + 1 and res.iter == ITER_STOP,
            f"optimize: {res.message}, series {series}")
    require(all(math.isfinite(v) for v in series),
            f"J_T series not finite: {series}")
    require(all(b < a for a, b in zip(series, series[1:])),
            f"J_T does not fall monotonically: {series}")

    # ---- the counts, read just after the main path ------------------------
    counts = read_counts(hopper_prop, hopper_frechet, hopper_cheby)
    n_fg += res.fg_calls
    n_f = res.f_calls
    expect = dict.fromkeys(counts, 0)
    expect.update({"forward_scan_shared": n_fg + n_f,
                   "chi_scan_shared": n_fg,
                   "frechet_trace_shared_factored": n_fg})
    require(counts == expect,
            f"launch counts {counts} do not match the evaluations {expect}")
    # every propagator and state chain of the main path on the redesigned
    # kernels: one propagator launch and one forward scan per forward pass,
    # one co-state scan per gradient
    routes_main = ROUTE_READS[-1][1]
    expect_routes = dict.fromkeys(routes_main, 0)
    expect_routes.update({"propagators_cluster": n_fg + n_f,
                          "state_scan_forward": n_fg + n_f,
                          "state_scan_chi": n_fg})
    require(routes_main == expect_routes, f"main-path route launches "
            f"{routes_main} do not match the evaluations {expect_routes}")
    # iteration 0 is the set-up (compile_problem, the guess's fg); the
    # steady rate is taken over iterations 1..ITER_STOP
    steady_s = sum(iter_secs[1:])
    emit({"phase": "optimize", "J_T_series": series, "iterations": res.iter,
          "seconds": opt_s, "iters_per_second": res.iter / opt_s,
          "iteration_seconds": iter_secs, "iteration_fg_calls": iter_fg,
          "steady_ms_per_fg": steady_s / max(sum(iter_fg[1:]), 1) * 1e3,
          "steady_iters_per_second": ITER_STOP / steady_s,
          "fg_calls": res.fg_calls, "f_calls": res.f_calls,
          "message": res.message, "launches": counts,
          "route_launches": routes_main})

    # ---- the ensemble paths, each with its own counted run ----------------
    counts_ens, counts_pertraj, ens_series = ensemble_paths(
        ens_problem, cp_ens, s_ens)

    # ---- the qutrit ensemble, the taylor gradient, the per-step pass ------
    k7, counts_smalld, counts_cz_taylor, counts_qutrit_gradgen = (
        smalld_and_taylor_paths(problem, fg_ms, g, rng, dev))

    # ---- the Chebyshev path at dim 1024 -----------------------------------
    k8, counts_cheby = cheby_paths(rng, dev)
    k_taylor = taylor_order_phase(rng, dev)

    # ---- the last two TPU kernels, each with its counted run --------------
    k10, counts_time = time_grid_kernel_phase(cp_ens, s_ens, rng, dev)
    k11, counts_probe = karatsuba_kernel_phase(dev)

    # ---- recompute, running costs, nonlinear amplitudes, observables ------
    counts_rec = recompute_paths(ens_problem, cp_ens, ens_series)
    counts_rc, counts_q3 = running_cost_paths(problem, dev)
    counts_ca = custom_amplitude_path(problem)
    counts_obs = observables_path(problem, dev)

    # ---- this slice: non-Hermitian inputs, the open system, the host
    # modules around optimize, the profiler trace ---------------------------
    t_slice = time.perf_counter()
    cp_open = nonhermitian_kernel_phase(rng, dev)
    open_system_paths(cp_open, dev)
    host_module_paths(problem, dev)
    profile_phase(problem, dev)
    slice_s = time.perf_counter() - t_slice

    # ---- per-trajectory propagator settings and Krotov's method ----------
    t_hetero_krotov = time.perf_counter()
    counts_hetero, routes_hetero, wide_d1024, chains_d1024 = hetero_paths(
        dev)
    counts_krotov = krotov_paths(problem, dev)
    hetero_krotov_s = time.perf_counter() - t_hetero_krotov

    # ---- the CZ at 12 levels a transmon (dim 144) on the wide kernel -----
    routes_144 = dim144_path(dev)

    # ---- the optimizer backends and the device-resident loop -------------
    optimizer_paths(problem, ens_problem, dev)

    # ---- trajectory sharding over torch.distributed -----------------------
    counts_par = parallel_paths(problem, ens_problem, smi)

    # ---- the keywords, the examples, BASELINE config 5 at the letter ------
    t_kel = time.perf_counter()
    keyword_paths(problem, dev)
    counts_examples = example_paths()
    counts_letter, letter_check = letter_paths(dev)
    kel_s = time.perf_counter() - t_kel

    prop_cu = "grape_tpu_torch/csrc/prop_cluster.cu"
    smalld_cu = "grape_tpu_torch/csrc/smalld_fused.cu"
    cheby_cu = "grape_tpu_torch/csrc/cheby_ring.cu"
    counts_new = {
        "smalld_fused_kernel": k7["launches_fused_qutrit_run"],
        "cheby_ring_kernel": k8["routes_counted_runs"]["optimize_cheby"],
    }
    scan_cu = "grape_tpu_torch/csrc/state_scan.cu"
    frechet_cu = "grape_tpu_torch/csrc/frechet_trace.cu"
    factored_cu = "grape_tpu_torch/csrc/frechet_factored.cu"
    # name -> (source, what it replaces, the counted run that drives it).
    # Each Frechet wrapper runs one of two kernels, by operation count: the
    # factored one at d = 100 (the CZ and its ensembles), the dense one at
    # d = 3 (config 3's one evaluation, the qutrits' gradgen evaluation)
    # the two redesigned kernels under their own names, counted per route
    # in the main path's run (every wrapper below that forms propagators
    # or runs a state chain launches them)
    counts_routes = {
        "propagator_kernel_cluster": routes_main["propagators_cluster"],
        "state_scan_cluster": (routes_main["state_scan_forward"]
                               + routes_main["state_scan_chi"]),
        # this slice's two kernels, counted per route in the mixed cell's
        # optimization (dim 1024: both) and in the dim-144 CZ's runs
        "propagator_kernel_wide": routes_hetero["propagators_wide"],
        "state_scan_grid": (routes_hetero["state_scan_grid_forward"]
                            + routes_hetero["state_scan_grid_chi"]),
    }
    meta = {
        "propagator_kernel_cluster": (
            prop_cu, "grape_tpu/ops/pallas_prop.py:373", counts_routes),
        "state_scan_cluster": (
            scan_cu, "grape_tpu/ops/pallas_prop.py:607", counts_routes),
        "propagator_kernel_wide": (
            "grape_tpu_torch/csrc/prop_wide.cu",
            "grape_tpu/ops/pallas_prop.py:373", counts_routes),
        "state_scan_grid": (
            "grape_tpu_torch/csrc/state_grid.cu",
            "grape_tpu/ops/pallas_prop.py:607", counts_routes),
        "forward_scan_shared": (
            prop_cu, "grape_tpu/ops/pallas_prop.py:373", counts),
        "chi_scan_shared": (
            scan_cu, "grape_tpu/ops/pallas_prop.py:607", counts),
        "frechet_trace_shared_factored": (
            factored_cu, "grape_tpu/ops/pallas_frechet.py:257", counts),
        "frechet_trace_shared": (
            frechet_cu, "grape_tpu/ops/pallas_frechet.py:257", counts_q3),
        "forward_scan_grouped": (
            prop_cu, "grape_tpu/ops/pallas_prop.py:494", counts_ens),
        "forward_scan_pertraj": (
            prop_cu, "grape_tpu/ops/pallas_prop.py:144", counts_pertraj),
        "frechet_trace_pertraj_factored": (
            factored_cu, "grape_tpu/ops/pallas_frechet.py:350", counts_ens),
        "frechet_trace_pertraj": (
            frechet_cu, "grape_tpu/ops/pallas_frechet.py:350",
            counts_qutrit_gradgen),
        # the grouped co-state chains: scans of small products in the
        # reference, the chi-scan kernel with a group axis here
        "chi_scan_grouped": (
            scan_cu, "grape_tpu/fg.py:1719", counts_ens),
        "chi_scan_recompute": (
            prop_cu, "grape_tpu/fg.py:1745", counts_pertraj),
        "forward_scan_smalld": (
            smalld_cu, "grape_tpu/ops/pallas_prop.py:766", counts_smalld),
        # one kernel for both TPU kernels of the Chebyshev regime
        "cheby_scan": (
            cheby_cu, "grape_tpu/ops/pallas_prop.py:956 and :1183",
            counts_cheby),
        # the two redesigned kernels of this slice under their own names,
        # counted per route in the qutrits' and the dim-1024 runs
        "smalld_fused_kernel": (
            smalld_cu, "grape_tpu/ops/pallas_prop.py:766", counts_new),
        "cheby_ring_kernel": (
            cheby_cu, "grape_tpu/ops/pallas_prop.py:956 and :1183",
            counts_new),
        # the per-trajectory scan without the U stream: the K5 pair of
        # kernels (or the fused small-d kernel under its gates)
        "forward_scan_time": (
            prop_cu, "grape_tpu/ops/pallas_prop.py:275", counts_time),
        "karatsuba_chain": (
            "grape_tpu_torch/csrc/karatsuba_chain.cu",
            "experiments/mxu_probe.py:90", counts_probe),
        # no TPU kernel: the JAX package leaves the Taylor pass to XLA's
        # einsums; launched once an order in the dim-1024 run
        "taylor_order": (
            "grape_tpu_torch/csrc/taylor_order.cu",
            "none (grape_tpu/fg.py _backward_vectorized: XLA einsums)",
            counts_cheby),
    }
    cz = {
        name: {"err": err[name], "ms": ms[name], "plain_ms": plain_ms[name],
               "flops": flops[name], "bytes": byts[name],
               "library_ms": None}
        for name in ("forward_scan_shared", "chi_scan_shared",
                     "frechet_trace_shared", "frechet_trace_shared_factored")
    }
    cz["forward_scan_shared"].update(
        library_ms=library_ms, propagators_only_ms=propagators_ms,
        library_call="torch.linalg.matrix_exp on (N_T, d, d): the "
                     "propagators only")
    cz["frechet_trace_shared"].update(
        algorithm_flops=frechet_algorithm_flops["dense"])
    cz["frechet_trace_shared_factored"].update(
        algorithm_flops=frechet_algorithm_flops["factored"],
        under_load=frechet_under_load, ms_by_steps=frechet_ms_by_steps,
        ms_by_items_per_launch=frechet_ms_by_launch)
    k_prop.update(
        replaces_all="grape_tpu/ops/pallas_prop.py:144, :275, :373, :494 "
                     "(the propagator half of K5, K10, K1, K4) and the "
                     "re-formed propagators of chi_scan_recompute",
        routes_main_path=routes_main)
    k_scan.update(
        library_ms=None,
        replaces_all="grape_tpu/ops/pallas_prop.py:607 (K2) and the apply "
                     "half of :373, :494, :144 (K1, K4, K5); the grouped "
                     "and windowed co-state chains",
        routes_main_path=routes_main)
    k_wide.update(
        replaces_all="grape_tpu/ops/pallas_prop.py:144, :275, :373, :494 "
                     "(the propagator half of K5, K10, K1, K4) past d = 108",
        replaces_route="the global-scratch kernel of csrc/prop_scan.cu "
                       "(global_route_ms)",
        hetero_d1024=wide_d1024,
        launches_dim144=routes_144["propagators_wide"])
    k_grid.update(
        library_ms=None,
        replaces_all="grape_tpu/ops/pallas_prop.py:607 (K2) and the apply "
                     "half of :373, :494, :144 past the cluster scan",
        replaces_route="the one-block scans of csrc/prop_scan.cu "
                       "(legacy_ms, legacy_ms_chi)",
        hetero_chains_d1024={k: chains_d1024[k] for k in (
            "forward_scan_vs_plain_on_kernel_U",
            "chi_scan_vs_plain_on_kernel_U", "forward_states_vs_plain",
            "forward_states_limit")})
    measured = {**cz, **ens, "forward_scan_smalld": k7, "cheby_scan": k8,
                "smalld_fused_kernel": dict(k7, replaces_route=(
                    "the two-launch pair of csrc/smalld_scan.cu (pair_ms)")),
                "cheby_ring_kernel": dict(k8, replaces_route=(
                    "the grid-barrier kernel of csrc/cheby_scan.cu "
                    "(grid_ms)")),
                "forward_scan_time": k10, "karatsuba_chain": k11,
                "taylor_order": k_taylor,
                "propagator_kernel_cluster": k_prop,
                "state_scan_cluster": k_scan,
                "propagator_kernel_wide": k_wide,
                "state_scan_grid": k_grid}
    # launches on this slice's paths, beside the counted run of each kernel
    for name, m in measured.items():
        for path, c in (("main_path", counts), ("ensemble", counts_ens),
                        ("per_trajectory", counts_pertraj),
                        ("config3", counts_q3),
                        ("qutrit_gradgen", counts_qutrit_gradgen),
                        ("recompute", counts_rec),
                        ("running_cost", counts_rc),
                        ("custom_amplitude", counts_ca),
                        ("observables", counts_obs),
                        ("hetero", counts_hetero),
                        ("krotov", counts_krotov),
                        ("parallel_world_of_one", counts_par),
                        ("examples", counts_examples),
                        ("letter", counts_letter)):
            if c.get(name):
                m[f"launches_{path}"] = c[name]
    # the ensemble kernels at the letter's segment shape (G = 1024)
    for name in ("forward_scan_grouped", "chi_scan_grouped",
                 "frechet_trace_pertraj_factored"):
        ens[name]["letter_segment"] = {
            "shape": letter_check["shape"],
            "ms": letter_check["ms"][name],
            "max_abs_err_vs_plain": letter_check["max_abs_err"][name]}
    # launches on the taylor paths, beside the counted run of each kernel
    cz["forward_scan_shared"]["launches_cz_taylor"] = (
        counts_cz_taylor["forward_scan_shared"])
    cz["chi_scan_shared"]["launches_cz_taylor"] = (
        counts_cz_taylor["chi_scan_shared"])
    ens["chi_scan_grouped"]["launches_qutrit_taylor"] = (
        counts_smalld["chi_scan_grouped"])
    # the propagator half of K1 at d = 1024 on the wide route (the
    # heterogeneous cell's ExpProp partition)
    cz["forward_scan_shared"]["propagators_wide_d1024"] = wide_d1024
    kernels = []
    for name, (source, replaces, run_counts) in meta.items():
        m = dict(measured[name])
        b_ms, b_by = bound(m["flops"], m["bytes"])
        require(run_counts[name] >= 1,
                f"{name} was launched no time on the path that uses it")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": run_counts[name],
            "max_abs_err": m.pop("err"), "ms": m.pop("ms"),
            "plain_ms": m.pop("plain_ms"), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": m.pop("library_ms"), **m,
        })
    # every counted run took the redesigned kernels: no launch of the
    # global-scratch propagator kernel, the one-block scans, the two-launch
    # small-d pair or the grid-barrier Chebyshev kernel (those run only
    # where a phase above forces them, or past the new kernels' limits)
    old_routes = ("propagators_global", "state_scan_legacy_forward",
                  "state_scan_legacy_chi", "state_scan_legacy_chi_by_apply",
                  "smalld_pair", "cheby_grid")
    for site, routes in ROUTE_READS:
        require(all(routes.get(k, 0) == 0 for k in old_routes),
                f"the counted run of {site} took an old kernel: {routes}")
    emit({"phase": "route_launches", "counted_runs": [
        {"run": site, **routes} for site, routes in ROUTE_READS]})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start,
          "host_module_phases_seconds": slice_s,
          "hetero_krotov_phases_seconds": hetero_krotov_s,
          "keywords_examples_letter_seconds": kel_s,
          "nvidia_smi": smi})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
