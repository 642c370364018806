#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the three CUDA kernels from ``grape_tpu_torch/csrc`` and holds each
against its plain PyTorch version on the card at the main path's shapes
(the two-transmon CZ gate: dim = 100, K = 4 trajectories, T = 4 control
terms, N_T = 2000 steps) and at a few other shapes, then runs the same
problem through ``compile_problem`` / ``build_fg`` and through five
L-BFGS-B iterations of ``optimize_problem``, and checks that every
evaluation went through the kernels.  Each phase prints one JSON line and raises on failure; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device the
script exits with a non-zero code and prints no result.

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

# main-path configuration (BASELINE config 4)
D_TRANSMON, N_STEPS, ITER_STOP = 10, 2000, 5
SEED = 0

# published peaks of one H100 SXM (dense, no sparsity)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# kernel-vs-plain tolerances on the card (float32 arithmetic on both sides,
# sums taken in another order): states and propagators of unit scale after
# N_T = 2000 compounding steps, and the traces relative to their scale
TOL_STATE = 5e-5
TOL_TRJ = 2e-5


def emit(obj):
    print(json.dumps(obj), flush=True)


def require(cond, msg):
    """A check that survives ``python -O`` (unlike ``assert``)."""
    if not cond:
        raise AssertionError(msg)


def median_ms(fn, reps=5):
    """Median CUDA-event time of ``fn`` in ms, after one warm call."""
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
    return float(np.median(times))


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
    doublings, counted for the cheapest evaluation known rather than for
    the kernel's.

    The direction has rank one, so
    ``L = sum_{i+j<=15} c_{i+j+1} (A^i psi)(chi^+ A^j)`` has rank <= 16 and
    never needs a dense product: 15 + 15 matrix-vector products build the
    two Krylov sets, ``16 T`` more give ``Op_t A^i psi`` and 136 ``T`` dot
    products finish the traces.  Each doubling ``L <- E_j L + L E_j``
    doubles the rank, multiplying every vector of both sets by ``E_j``;
    only then is the dense base needed (the polynomial, 6 products, and
    ``s - 1`` squarings for the ladder).  Where the factored count exceeds
    the dense one (large ``s``) the dense one is taken.
    """
    mv = 8.0 * d * d            # complex (d, d) by (d,) product
    cmm = 8.0 * d ** 3          # complex (d, d) by (d, d) product
    gen = (4.0 * T + 2.0) * d * d   # A_n = -i dt (H0 + sum_t c_t Op_t)
    rank = 16 * 2 ** s
    factored = gen + (0 if s == 0 else (5 + s) * cmm) + K * (
        30 * mv                     # A^i psi, chi^+ A^j, i, j = 1..15
        + 2 * 16 * (2 ** s - 1) * mv    # the doublings, in factored form
        + T * rank * mv             # Op_t u for every left vector u
        + T * 136 * 2 ** s * 8.0 * d    # the dot products of the traces
    )
    dense = gen + (5 + s) * cmm + K * (
        (12 + 2 * s) * cmm + 8.0 * T * d * d
    )
    return N_T * min(factored, dense)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: "
              "torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    t_start = time.perf_counter()

    import grape_tpu_torch as gt
    from grape_tpu_torch.fg import _static_squarings
    from grape_tpu_torch.models import two_transmon_cz_problem
    from grape_tpu_torch.ops import _build, hopper_frechet, hopper_prop
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
    _build.load_kernels()
    kernels_s = time.perf_counter() - t0
    lbfgsb._load()  # the host optimizer (g++), so phase 5 times no build
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels_seconds": kernels_s,
          "rebuilt": _build.last_build["rebuilt"],
          "sources": [os.path.relpath(p, HERE)
                      for p in sum(_build.kernel_sources(), [])]})

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
           "frechet_trace_shared": 0.0}
    checks = []
    for s in sorted({s_cz, 2}):
        st, U = hopper_prop.forward_scan_shared(H0, ops, coeffs, dts, psi0, s)
        torch.cuda.synchronize()
        chis = hopper_prop.chi_scan_shared(U, chi0)
        torch.cuda.synchronize()
        psis = st[:-1].contiguous()
        trj = hopper_frechet.frechet_trace_shared(
            H0, ops, coeffs, dts, psis, chis, s
        )
        torch.cuda.synchronize()
        with plain_versions():
            st_p, U_p = hopper_prop.forward_scan_shared(
                H0, ops, coeffs, dts, psi0, s
            )
            chis_p = hopper_prop.chi_scan_shared(U, chi0)
            trj_p = hopper_frechet.frechet_trace_shared(
                H0, ops, coeffs, dts, psis, chis, s
            )
        torch.cuda.synchronize()
        for x in (st, U, chis, trj):
            require(bool(torch.isfinite(torch.view_as_real(x)).all()),
                    f"a kernel output is not finite at s={s}")
        require(st.shape == (N_T + 1, K, d) and U.shape == (N_T, d, d)
                and chis.shape == (N_T, K, d) and trj.shape == (N_T, K, T),
                "a kernel output has the wrong shape")
        e_fwd = max(max_abs(st, st_p), max_abs(U, U_p))
        e_chi = max_abs(chis, chis_p)
        scale = max(float(trj_p.abs().max()), 1.0)
        e_trj = max_abs(trj, trj_p)
        checks.append({"s": s, "forward": e_fwd, "chi": e_chi,
                       "trj": e_trj, "trj_scale": scale,
                       "trj_max": float(trj_p.abs().max())})
        require(e_fwd < TOL_STATE,
                f"forward scan disagrees at s={s}: {e_fwd}")
        require(e_chi < TOL_STATE, f"chi scan disagrees at s={s}: {e_chi}")
        require(e_trj < TOL_TRJ * scale,
                f"Frechet trace disagrees at s={s}: {e_trj}")
        err["forward_scan_shared"] = max(err["forward_scan_shared"], e_fwd)
        err["chi_scan_shared"] = max(err["chi_scan_shared"], e_chi)
        err["frechet_trace_shared"] = max(err["frechet_trace_shared"], e_trj)
    emit({"phase": "kernel_check", "shape": {"d": d, "K": K, "T": T,
                                             "N_T": N_T},
          "s_main_path": s_cz, "tol_state": TOL_STATE,
          "tol_trj_of_scale": TOL_TRJ, "checks": checks})

    # other shapes than the main path's: ragged tiles (d not a multiple of
    # 64, d > 128), more trajectories than one scan block holds, one step,
    # tiny d.  The CPU tests cannot reach the CUDA code, so the general
    # shape handling is held against the plain versions here.
    shape_checks = []
    for (d_, K_, T_, N_, s_, h_) in [(128, 8, 1, 5, 0, 10.0),
                                     (5, 1, 3, 1, 4, 100.0),
                                     (64, 9, 2, 300, 1, 20.0),
                                     (130, 2, 2, 3, 1, 20.0),
                                     (2, 1, 1, 500, 0, 5.0)]:
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
        trj = hopper_frechet.frechet_trace_shared(Hs, Os, cs, ts, psis, chis,
                                                  s_)
        torch.cuda.synchronize()
        with plain_versions():
            st_p, U_p = hopper_prop.forward_scan_shared(Hs, Os, cs, ts, p0, s_)
            chis_p = hopper_prop.chi_scan_shared(U, x0_)
            trj_p = hopper_frechet.frechet_trace_shared(Hs, Os, cs, ts, psis,
                                                        chis, s_)
        worst = max(max_abs(st, st_p), max_abs(U, U_p),
                    max_abs(chis, chis_p),
                    max_abs(trj, trj_p) / max(float(trj_p.abs().max()), 1.0))
        shape_checks.append({"d": d_, "K": K_, "T": T_, "N_T": N_, "s": s_,
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
    ms = {
        "forward_scan_shared": median_ms(
            lambda: hopper_prop.forward_scan_shared(
                H0, ops, coeffs, dts, psi0, s)),
        "chi_scan_shared": median_ms(
            lambda: hopper_prop.chi_scan_shared(U, chi0)),
        "frechet_trace_shared": median_ms(
            lambda: hopper_frechet.frechet_trace_shared(
                H0, ops, coeffs, dts, psis, chis, s)),
    }
    propagators_ms = median_ms(
        lambda: hopper_prop.propagators_shared(H0, ops, coeffs, dts, s))
    with plain_versions():
        plain_ms = {
            "forward_scan_shared": median_ms(
                lambda: hopper_prop.forward_scan_shared(
                    H0, ops, coeffs, dts, psi0, s), reps=3),
            "chi_scan_shared": median_ms(
                lambda: hopper_prop.chi_scan_shared(U, chi0), reps=3),
            "frechet_trace_shared": median_ms(
                lambda: hopper_frechet.frechet_trace_shared(
                    H0, ops, coeffs, dts, psis, chis, s), reps=3),
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
        "frechet_trace_shared": frechet_needed_flops(d, K, T, N_T, s),
    }
    # what the Frechet kernel's own algorithm does (every product dense);
    # reported beside the bound, never used for it
    frechet_algorithm_flops = N_T * (
        (5 + s) * cmm + K * ((12 + 2 * s) * cmm + 8.0 * T * d * d)
    )
    byts = {
        "forward_scan_shared": nbytes(H0, ops, coeffs, dts, psi0, st, U),
        "chi_scan_shared": nbytes(U, chi0, chis),
        "frechet_trace_shared": nbytes(H0, ops, coeffs, dts, psis, chis,
                                       trj),
    }

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
    for counts in (hopper_prop.launches, hopper_frechet.launches):
        for key in counts:
            counts[key] = 0

    # ---- phase 4: one fg evaluation through compile_problem / build_fg ----
    fg = gt.build_fg(cp)
    x0 = cp.guess_pulsevals.reshape(-1)
    J, g, aux = fg(x0)
    torch.cuda.synchronize()
    n_fg = 1
    counts_after_one = {**hopper_prop.launches, **hopper_frechet.launches}
    require(all(v >= 1 for v in counts_after_one.values()),
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
    with plain_versions():
        t0 = time.perf_counter()
        fg(x0)
        torch.cuda.synchronize()
        fg_plain_ms = (time.perf_counter() - t0) * 1e3
    emit({"phase": "fg", "J": float(J), "grad_norm": float(g.norm()),
          "ms_per_eval": fg_ms, "plain_ms_per_eval": fg_plain_ms,
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
    counts = {**hopper_prop.launches, **hopper_frechet.launches}
    n_fg += res.fg_calls
    n_f = res.f_calls
    expect = {"forward_scan_shared": n_fg + n_f, "chi_scan_shared": n_fg,
              "frechet_trace_shared": n_fg}
    require(counts == expect,
            f"launch counts {counts} do not match the evaluations {expect}")
    # iteration 0 is the set-up (compile_problem, the guess's fg); the
    # steady rate is taken over iterations 1..ITER_STOP
    steady_s = sum(iter_secs[1:])
    emit({"phase": "optimize", "J_T_series": series, "iterations": res.iter,
          "seconds": opt_s, "iters_per_second": res.iter / opt_s,
          "iteration_seconds": iter_secs, "iteration_fg_calls": iter_fg,
          "steady_ms_per_fg": steady_s / max(sum(iter_fg[1:]), 1) * 1e3,
          "steady_iters_per_second": ITER_STOP / steady_s,
          "fg_calls": res.fg_calls, "f_calls": res.f_calls,
          "message": res.message, "launches": counts})

    meta = {
        "forward_scan_shared": (
            "grape_tpu_torch/csrc/prop_scan.cu",
            "grape_tpu/ops/pallas_prop.py:373"),
        "chi_scan_shared": (
            "grape_tpu_torch/csrc/prop_scan.cu",
            "grape_tpu/ops/pallas_prop.py:607"),
        "frechet_trace_shared": (
            "grape_tpu_torch/csrc/frechet_trace.cu",
            "grape_tpu/ops/pallas_frechet.py:257"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        b_ms, b_by = bound(flops[name], byts[name])
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": err[name], "ms": ms[name],
            "plain_ms": plain_ms[name], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": (library_ms if name == "forward_scan_shared"
                           else None),
            "flops": flops[name], "bytes": byts[name],
        })
    kernels[0]["propagators_only_ms"] = propagators_ms
    kernels[2]["algorithm_flops"] = frechet_algorithm_flops
    kernels[0]["library_call"] = (
        "torch.linalg.matrix_exp on (N_T, d, d): the propagators only"
    )
    emit({"phase": "total", "seconds": time.perf_counter() - t_start,
          "nvidia_smi": smi})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
