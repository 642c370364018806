"""Build and load the hand-written CUDA kernels.

The sources under ``grape_tpu_torch/csrc`` are compiled with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface and loaded with
``ctypes`` (no PyTorch headers: the build takes seconds).  Each ``.cu`` is
compiled to an object file by its own ``nvcc`` process, all started
together, then linked.  The library is built at first use and rebuilt when a
source is newer than it.

The build directory is ``build/grape_tpu_torch`` beside the package (listed
in ``.gitignore``).
"""

import ctypes
import os
import shutil
import subprocess
import time

__all__ = ["build_dir", "load_kernels", "load_phase_clock", "kernel_sources",
           "last_build"]

_PKG = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
_CSRC = os.path.join(_PKG, "csrc")
_LIB = None
_CLOCK_LIB = None
# the kernels that carry phase clocks (csrc/phase_clock.cuh)
_CLOCKED = ("prop_cluster.cu", "state_scan.cu", "cheby_ring.cu",
            "frechet_factored.cu")
# {"seconds": float, "rebuilt": bool, "log": str} of the latest load
last_build = {}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]


def build_dir():
    """The (created) directory that holds everything this package builds."""
    path = os.path.join(os.path.dirname(_PKG), "build", "grape_tpu_torch")
    os.makedirs(path, exist_ok=True)
    return path


def kernel_sources():
    """``(cu_files, header_files)`` under ``csrc``, sorted."""
    names = sorted(os.listdir(_CSRC))
    cu = [os.path.join(_CSRC, n) for n in names if n.endswith(".cu")]
    hdr = [os.path.join(_CSRC, n) for n in names if n.endswith(".cuh")]
    return cu, hdr


def _nvcc():
    exe = shutil.which("nvcc")
    if exe is None:
        cand = os.path.join(
            os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"
        )
        if os.path.exists(cand):
            exe = cand
    if exe is None:
        raise RuntimeError(
            "nvcc not found: the grape_tpu_torch CUDA kernels are built "
            "from source at first use and need the CUDA toolkit"
        )
    return exe


def _build(so, verbose, cu=None, defines=()):
    nvcc = _nvcc()
    if cu is None:
        cu, _ = kernel_sources()
    out = build_dir()
    extra = (["-Xptxas", "-v"] if verbose else []) + [
        f"-D{name}" for name in defines]
    procs = []
    objs = []
    for src in cu:
        obj = os.path.join(
            out, os.path.basename(src)[:-3] + f".{os.getpid()}.o"
        )
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *extra, "-c", src, "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    log = []
    failed = False
    for src, p in zip(cu, procs):
        text, _ = p.communicate()
        log.append(f"== nvcc {os.path.basename(src)} (rc {p.returncode})\n"
                   f"{text}")
        failed = failed or p.returncode != 0
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(log))
    tmp = f"{so}.{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    log.append(f"== link (rc {link.returncode})\n{link.stdout}")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + "\n".join(log))
    os.replace(tmp, so)
    return "\n".join(log)


def _declare(lib):
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.grape_propagators.restype = i
    lib.grape_propagators.argtypes = [
        p, p, p, p, i, i, i, i, ll, i, p, i, p, p,
    ]
    lib.grape_forward_apply.restype = i
    lib.grape_forward_apply.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.grape_chi_scan.restype = i
    lib.grape_chi_scan.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.grape_frechet_trace.restype = i
    lib.grape_frechet_trace.argtypes = [
        p, p, p, p, p, p, i, i, i, i, i, i, ll, i, p, i, p, p,
    ]
    lib.grape_smalld_propagators.restype = i
    lib.grape_smalld_propagators.argtypes = [p, p, p, p, i, i, i, i, i, p, p]
    lib.grape_smalld_apply.restype = i
    lib.grape_smalld_apply.argtypes = [p, p, p, i, i, i, p]
    lib.grape_smalld_fused.restype = i
    lib.grape_smalld_fused.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p,
                                       p, p]
    lib.grape_cheby_ring.restype = i
    lib.grape_cheby_ring.argtypes = [
        p, p, p, p, ctypes.c_float, ctypes.c_float, p, i, i, i, i, i, i, i,
        i, i, i, i, i, p, p, p, p,
    ]
    lib.grape_cheby_scan.restype = i
    lib.grape_cheby_scan.argtypes = [
        p, p, p, p, ctypes.c_float, ctypes.c_float, p, i, i, i, i, i, i, p,
        p, p,
    ]
    lib.grape_cheby_scan_layout.restype = i
    lib.grape_cheby_scan_layout.argtypes = [i, i, ctypes.POINTER(i)]
    lib.grape_karatsuba_chain.restype = i
    lib.grape_karatsuba_chain.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.grape_propagator_scratch_matrices.restype = i
    lib.grape_propagator_scratch_matrices.argtypes = []
    lib.grape_frechet_scratch_matrices.restype = i
    lib.grape_frechet_scratch_matrices.argtypes = [i]
    lib.grape_frechet_factored_plan.restype = i
    lib.grape_frechet_factored_plan.argtypes = [
        i, i, i, i, ll, ctypes.POINTER(i), ctypes.POINTER(ll),
    ]
    lib.grape_frechet_factored.restype = i
    lib.grape_frechet_factored.argtypes = [
        p, p, p, p, p, p, i, i, i, i, i, i, ll, i, i, i, i, i, p, ll, i, p,
        p,
    ]
    lib.grape_propagators_cluster.restype = i
    lib.grape_propagators_cluster.argtypes = [p, p, p, p, i, i, i, i, ll, i,
                                              p, p]
    lib.grape_propagators_cluster_resident.restype = i
    lib.grape_propagators_cluster_resident.argtypes = [i]
    lib.grape_state_scan.restype = i
    lib.grape_state_scan.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, p]
    lib.grape_propagators_wide.restype = i
    lib.grape_propagators_wide.argtypes = [p, p, p, p, i, i, i, i, ll, i, p,
                                           i, i, p, p]
    lib.grape_propagators_wide_scratch_floats.restype = ll
    lib.grape_propagators_wide_scratch_floats.argtypes = [i, i, i]
    lib.grape_state_grid.restype = i
    lib.grape_state_grid.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i,
                                     i, i, p, p, p]
    lib.grape_state_scan_resident.restype = i
    lib.grape_state_scan_resident.argtypes = [i, i, i, i, i, i, i]
    lib.grape_taylor_order_plan.restype = i
    lib.grape_taylor_order_plan.argtypes = [i, i, i, ctypes.POINTER(i)]
    lib.grape_taylor_order.restype = i
    lib.grape_taylor_order.argtypes = [
        p, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i,
        ctypes.c_float, p,
    ]
    lib.grape_error_string.restype = ctypes.c_char_p
    lib.grape_error_string.argtypes = [i]


def _declare_clocked(lib):
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.grape_propagators_cluster.restype = i
    lib.grape_propagators_cluster.argtypes = [p, p, p, p, i, i, i, i, ll, i,
                                              p, p]
    lib.grape_state_scan.restype = i
    lib.grape_state_scan.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, p]
    lib.grape_propagators_cluster_resident.restype = i
    lib.grape_propagators_cluster_resident.argtypes = [i]
    lib.grape_cheby_ring.restype = i
    lib.grape_cheby_ring.argtypes = [
        p, p, p, p, ctypes.c_float, ctypes.c_float, p, i, i, i, i, i, i, i,
        i, i, i, i, i, p, p, p, p,
    ]
    lib.grape_frechet_factored_plan.restype = i
    lib.grape_frechet_factored_plan.argtypes = [
        i, i, i, i, ll, ctypes.POINTER(i), ctypes.POINTER(ll),
    ]
    lib.grape_frechet_factored.restype = i
    lib.grape_frechet_factored.argtypes = [
        p, p, p, p, p, p, i, i, i, i, i, i, ll, i, i, i, i, i, p, ll, i, p,
        p,
    ]
    for fn in (lib.grape_propagators_cluster_clock,
               lib.grape_state_scan_clock, lib.grape_cheby_ring_clock,
               lib.grape_frechet_factored_clock):
        fn.restype = i
        fn.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]


def load_kernels(verbose=False):
    """The loaded kernel library (built first if missing or stale)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    t0 = time.perf_counter()
    so = os.path.join(build_dir(), "libgrape_kernels.so")
    cu, hdr = kernel_sources()
    newest = max(os.path.getmtime(f) for f in cu + hdr)
    rebuilt = False
    log = ""
    if not os.path.exists(so) or os.path.getmtime(so) < newest:
        log = _build(so, verbose)
        rebuilt = True
    lib = ctypes.CDLL(so)
    _declare(lib)
    _LIB = lib
    last_build.update(
        seconds=time.perf_counter() - t0, rebuilt=rebuilt, log=log
    )
    return lib


def load_phase_clock():
    """The two cluster kernels (``csrc/prop_cluster.cu``,
    ``csrc/state_scan.cu``), the Chebyshev ring kernel
    (``csrc/cheby_ring.cu``) and the factored Fréchet kernel
    (``csrc/frechet_factored.cu``) built again with their phase clocks
    (``-DGRAPE_PHASE_CLOCK``) into a library of their own, for
    measurements only: the same entry points, each launch also adding the
    SM cycles of block 0 per phase to a table that
    ``grape_propagators_cluster_clock`` / ``grape_state_scan_clock`` /
    ``grape_cheby_ring_clock`` / ``grape_frechet_factored_clock`` copy out
    (16 counters) and clear.  Built at first use, like
    :func:`load_kernels`."""
    global _CLOCK_LIB
    if _CLOCK_LIB is not None:
        return _CLOCK_LIB
    so = os.path.join(build_dir(), "libgrape_phase_clock.so")
    cu = [os.path.join(_CSRC, n) for n in _CLOCKED]
    _, hdr = kernel_sources()
    newest = max(os.path.getmtime(f) for f in cu + hdr)
    if not os.path.exists(so) or os.path.getmtime(so) < newest:
        _build(so, False, cu=cu, defines=("GRAPE_PHASE_CLOCK",))
    lib = ctypes.CDLL(so)
    _declare_clocked(lib)
    _CLOCK_LIB = lib
    return lib


def check(lib, code, what):
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        msg = lib.grape_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
