"""Native C++ L-BFGS-B reverse-communication backend (default optimizer).

ctypes binding to ``grape_tpu_torch/native/lbfgsb.cpp`` plus the GRAPE task loop,
mirroring the reference's L-BFGS-B extension
(``ext/GRAPELBFGSBExt.jl:18-143``): "extreme" default
tolerances (``factr=1e1``, ``pgtol=1e-15``) so GRAPE's own convergence layer
governs; FG_START iteration-0 callback; NEW_X per-iteration
update/callback/convergence-check with early stop; termination-message
capture; and true iterate aliasing — the optimizer works directly on
``wrk.pulsevals``, so in-callback pulse mutation takes effect
(``test/test_iterations.jl:128-145`` semantics).

The shared library is built on demand with g++ into the package's build
directory (``ops._build.build_dir``), never next to the source.
"""

import ctypes
import os
import subprocess

import numpy as np

from ..tracing import span

_LIB = None

_SRC = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "native", "lbfgsb.cpp")
)


def _so_path():
    from ..ops._build import build_dir

    return os.path.join(build_dir(), "liblbfgsb.so")


def _build(so):
    # compile to a private name, then rename: concurrent first uses (test
    # workers) never load a half-written library
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
        "-o", tmp, _SRC,
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, so)


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    so = _so_path()
    if (not os.path.exists(so)) or (
        os.path.getmtime(so) < os.path.getmtime(_SRC)
    ):
        _build(so)
    lib = ctypes.CDLL(so)
    lib.lbfgsb_create.restype = ctypes.c_void_p
    lib.lbfgsb_create.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.lbfgsb_destroy.argtypes = [ctypes.c_void_p]
    lib.lbfgsb_set_bounds.argtypes = [
        ctypes.c_void_p,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
    ]
    lib.lbfgsb_step.restype = ctypes.c_int
    lib.lbfgsb_step.argtypes = [
        ctypes.c_void_p,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ctypes.c_double,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ctypes.c_double,
        ctypes.c_double,
    ]
    lib.lbfgsb_task_msg.restype = ctypes.c_char_p
    lib.lbfgsb_task_msg.argtypes = [ctypes.c_void_p]
    lib.lbfgsb_step_width.restype = ctypes.c_double
    lib.lbfgsb_step_width.argtypes = [ctypes.c_void_p]
    lib.lbfgsb_search_direction.argtypes = [
        ctypes.c_void_p,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
    ]
    lib.lbfgsb_n_iter.restype = ctypes.c_int
    lib.lbfgsb_n_iter.argtypes = [ctypes.c_void_p]
    lib.lbfgsb_projgrad_norm.restype = ctypes.c_double
    lib.lbfgsb_projgrad_norm.argtypes = [ctypes.c_void_p]
    lib.lbfgsb_trace_info.argtypes = [
        ctypes.c_void_p,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
    ]
    _LIB = lib
    return lib


# task codes from the C API
_TASK_FG = 0
_TASK_NEW_X = 1
_TASK_CONVERGENCE = 2
_TASK_STOP = 3


class LBFGSB:
    """Reverse-communication L-BFGS-B task loop (reference defaults:
    ``m=10``, ``factr=1e1``, ``pgtol=1e-15``)."""

    def __init__(self, m=10, factr=1e1, pgtol=1e-15, iprint=-1):
        self.m = m
        self.factr = factr
        self.pgtol = pgtol
        self.iprint = iprint
        _load()

    def run(self, wrk, fg, callback, check_convergence):
        from ..optimize import apply_convergence_check, update_result

        lib = _load()
        n = wrk.n
        x = np.ascontiguousarray(wrk.pulsevals, dtype=np.float64)
        wrk.pulsevals = x  # alias: optimizer iterate IS the pulse vector
        st = lib.lbfgsb_create(n, self.m)
        try:
            # encode bounds (nbd codes 0/1/2/3 as in the Fortran interface,
            # ext/GRAPELBFGSBExt.jl:47-64 — with the correct finiteness test)
            lower = np.where(
                np.isfinite(wrk.lower_bounds), wrk.lower_bounds, 0.0
            ).astype(np.float64)
            upper = np.where(
                np.isfinite(wrk.upper_bounds), wrk.upper_bounds, 0.0
            ).astype(np.float64)
            has_l = np.isfinite(wrk.lower_bounds)
            has_u = np.isfinite(wrk.upper_bounds)
            nbd = np.zeros(n, dtype=np.int32)
            nbd[has_l & ~has_u] = 1
            nbd[has_l & has_u] = 2
            nbd[~has_l & has_u] = 3
            lib.lbfgsb_set_bounds(st, lower, upper, nbd)

            f = 0.0
            g = np.zeros(n)
            first_fg = True
            while True:
                with span("grape.lbfgsb"):
                    task = lib.lbfgsb_step(st, x, f, g, self.factr,
                                           self.pgtol)
                    msg = lib.lbfgsb_task_msg(st).decode()
                if task == _TASK_FG:
                    f = fg(f, g, x)
                    if first_fg:
                        # FG_START: x is the guess for iteration 0
                        first_fg = False
                        wrk.gradient_guess[:] = g
                        update_result(wrk, 0)
                        with span("grape.callback", hooks=True):
                            rec = callback(wrk, 0)
                            wrk.fg_count[:] = 0
                            if rec:
                                wrk.result.records.append(rec)
                elif task == _TASK_NEW_X:
                    self._capture_introspection(lib, st, wrk)
                    it = wrk.result.iter + 1
                    update_result(wrk, it)
                    with span("grape.callback", hooks=True):
                        rec = callback(wrk, wrk.result.iter)
                        wrk.fg_count[:] = 0
                        if rec:
                            wrk.result.records.append(rec)
                        apply_convergence_check(wrk.result,
                                                check_convergence)
                    if wrk.result.converged:
                        break  # "STOP: NEW_X -> CONVERGED"
                    wrk.pulsevals_guess[:] = x
                    wrk.gradient_guess[:] = g
                    if self.iprint >= 100:
                        self._print_trace(lib, st, wrk, msg)
                else:
                    # CONVERGENCE / STOP / ERROR: capture message
                    if wrk.result.message == "in progress":
                        wrk.result.message = msg
                    break
        finally:
            lib.lbfgsb_destroy(st)
        return None

    @staticmethod
    def _capture_introspection(lib, st, wrk):
        wrk.alpha = lib.lbfgsb_step_width(st)
        lib.lbfgsb_search_direction(st, wrk.searchdirection)

    @staticmethod
    def _print_trace(lib, st, wrk, msg):
        """Verbose per-iteration optimizer trace with annotated internals
        (``lbfgsb_iprint=100`` analog: the reference dumps the Fortran
        isave/dsave arrays with their meanings,
        ext/GRAPELBFGSBExt.jl:150-192; here the equivalent quantities of
        the C++ solver state)."""
        info = np.zeros(13)
        lib.lbfgsb_trace_info(st, info)
        n = wrk.n
        f = wrk.result.J_T + wrk.J_parts[1] + wrk.J_parts[2]
        constrained = bool(
            np.any(np.isfinite(wrk.lower_bounds))
            or np.any(np.isfinite(wrk.upper_bounds))
        )
        print(f"- end of task loop: FG -> {msg}")
        rows = [
            ("iter", int(info[0]), "number of the current iteration"),
            ("constrained", constrained, "problem is constrained?"),
            ("ncorr", int(info[1]),
             "limited-memory (s, y) pairs currently stored"),
            ("theta", info[2], "current θ scaling of the B₀ matrix"),
            ("f_prev", info[3], "f(x) at the start of the iteration"),
            ("f", f, "f(x) at the accepted iterate"),
            ("|d|₂", info[4], "2-norm of the line-search direction vector"),
            ("step", info[5], "relative step length in the line search"),
            ("|proj g|∞", info[7],
             "infinity norm of the projected gradient"),
            ("ls_evals", int(info[8]),
             "function/gradient evaluations in the line search"),
            ("n_free", int(info[9]),
             f"free variables at the Cauchy point (of n={n})"),
            ("n_active", int(info[10]),
             "variables at active bound constraints"),
            ("cauchy_intervals", int(info[11]),
             "intervals explored in the Cauchy-point search (this iter)"),
            ("cauchy_total", int(info[12]),
             "... accumulated over the run"),
            ("skipped_updates", int(info[6]),
             "weak-curvature BFGS updates rejected so far"),
        ]
        for key, val, meaning in rows:
            sval = f"{val:.6g}" if isinstance(val, float) else str(val)
            print(f"   {key:<17} = {sval:<14}\t {meaning}")
