"""The port stands alone: ``grape_tpu_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the JAX package, and an entry point that is not
told ``device="cpu"`` refuses to run without a CUDA device."""

import ast
import os

import numpy as np
import pytest
import torch

import grape_tpu_torch as gt
from grape_tpu_torch.functionals import J_T_sm
from grape_tpu_torch.models import (
    tls_problem, two_transmon_cz_ensemble_problem,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "optax", "grape_tpu")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _dirs, names in os.walk(os.path.join(ROOT, "grape_tpu_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 20  # the package and chip_smoke.py were found
    rel = {os.path.relpath(f, ROOT) for f in files}
    assert {"chip_smoke.py", "grape_tpu_torch/models/transmon.py",
            "grape_tpu_torch/ops/hopper_prop.py",
            "grape_tpu_torch/ops/hopper_frechet.py",
            "grape_tpu_torch/ops/frechet.py", "grape_tpu_torch/workspace.py",
            "grape_tpu_torch/generators.py", "grape_tpu_torch/propagate.py",
            "grape_tpu_torch/io.py", "grape_tpu_torch/testing.py",
            "grape_tpu_torch/flops.py",
            "grape_tpu_torch/models/open.py",
            "grape_tpu_torch/fg_hetero.py",
            "grape_tpu_torch/krotov.py",
            "grape_tpu_torch/parallel/mesh.py",
            "grape_tpu_torch/parallel/scaling.py"} <= rel
    from grape_tpu_torch.examples import NAMES

    assert {f"grape_tpu_torch/examples/{n}.py" for n in NAMES} <= rel
    bad = []
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in FORBIDDEN:
                bad.append((os.path.relpath(path, ROOT), mod))
    assert not bad, bad


def test_importing_the_port_does_not_load_jax():
    import subprocess
    import sys

    code = (
        "import sys, grape_tpu_torch, grape_tpu_torch.ops.hopper_prop, "
        "grape_tpu_torch.ops.hopper_frechet, grape_tpu_torch.optimizers.lbfgsb, "
        "grape_tpu_torch.testing, grape_tpu_torch.flops, grape_tpu_torch.io, "
        "grape_tpu_torch.models.open, grape_tpu_torch.fg_hetero, "
        "grape_tpu_torch.krotov, grape_tpu_torch.parallel, "
        "grape_tpu_torch.parallel.scaling, grape_tpu_torch.examples;"
        "from grape_tpu_torch.examples import NAMES;"
        "import importlib;"
        "[importlib.import_module('grape_tpu_torch.examples.' + n) "
        "for n in NAMES];"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'grape_tpu', 'triton')];"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True,
    )
    assert out.returncode == 0, out.stdout + out.stderr


ENTRY_POINTS = ["optimize", "optimize_problem", "compile_problem",
                "build_fg", "build_f", "compiled_problem_from_numpy",
                "ensemble", "optimize_krotov", "krotov_problem",
                "compile_heterogeneous", "hetero_build_fg",
                "hetero_optimize", "hetero_problem_from_numpy",
                "init_distributed", "make_mesh", "make_host_chip_mesh",
                "measure_weak_scaling", "build_fg_multicall",
                "example_main"]


def _mixed_trajectories():
    """Three TLS trajectories, one on the Chebyshev series: a partition."""
    problem = tls_problem(n_steps=10, J_T=J_T_sm)
    t0 = problem.trajectories[0]
    return [gt.Trajectory(t0.initial_state, t0.generator,
                          target_state=t0.target_state, **kw)
            for kw in ({"prop_method": "cheby"}, {}, {})], problem.tlist


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_device_none_raises_without_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("this check is about a machine without a CUDA device")
    problem = tls_problem(n_steps=10, J_T=J_T_sm)
    trajs, tlist = problem.trajectories, problem.tlist
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "optimize":
            gt.optimize(trajs, tlist, J_T=J_T_sm, rethrow_exceptions=True)
        elif entry == "optimize_problem":
            gt.optimize_problem(problem, rethrow_exceptions=True)
        elif entry == "compile_problem":
            gt.compile_problem(trajs, tlist, J_T=J_T_sm)
        elif entry == "compiled_problem_from_numpy":
            gt.compiled_problem_from_numpy({}, J_T="J_T_sm")
        elif entry == "ensemble":
            gt.optimize_problem(
                two_transmon_cz_ensemble_problem(n_samples=1, d=2,
                                                 n_steps=4),
                rethrow_exceptions=True,
            )
        elif entry == "optimize_krotov":
            gt.optimize_krotov(trajs, tlist, J_T=J_T_sm,
                               rethrow_exceptions=True)
        elif entry == "krotov_problem":
            gt.optimize_problem(problem, method="krotov",
                                rethrow_exceptions=True)
        elif entry == "compile_heterogeneous":
            mixed, tl = _mixed_trajectories()
            gt.fg_hetero.compile_heterogeneous(
                mixed, tl, gt.fg_hetero.traj_prop_partition(mixed, {}),
                J_T=J_T_sm)
        elif entry == "hetero_build_fg":
            mixed, tl = _mixed_trajectories()
            hp = gt.fg_hetero.compile_heterogeneous(
                mixed, tl, gt.fg_hetero.traj_prop_partition(mixed, {}),
                J_T=J_T_sm, device="cpu")
            # a problem compiled for the CPU, explicitly asked onto CUDA
            gt.build_fg(hp, device="cuda")(hp.guess_pulsevals.reshape(-1))
        elif entry == "hetero_optimize":
            mixed, tl = _mixed_trajectories()
            gt.optimize(mixed, tl, J_T=J_T_sm, rethrow_exceptions=True)
        elif entry == "init_distributed":
            # before any process group is opened
            gt.parallel.init_distributed("file:///nonexistent/store", 1, 0)
        elif entry in ("make_mesh", "make_host_chip_mesh"):
            getattr(gt.parallel, entry)()
        elif entry == "measure_weak_scaling":
            from grape_tpu_torch.parallel.scaling import measure_weak_scaling

            measure_weak_scaling(n_devices_list=[1], traj_per_device=1,
                                 dim=2, n_steps=2)
        elif entry == "build_fg_multicall":
            cp = gt.compile_problem(trajs, tlist, J_T=J_T_sm, device="cpu",
                                    storage_mode="recompute")
            gt.fg.build_fg_multicall(cp, n_calls=2, device="cuda")(
                cp.guess_pulsevals.reshape(-1))
        elif entry == "example_main":
            from grape_tpu_torch.examples import tls_state_transfer

            tls_state_transfer.main()
        elif entry == "hetero_problem_from_numpy":
            gt.hetero_problem_from_numpy({"parts": [], "part_idx": []},
                                         J_T="J_T_sm")
        else:
            cp = gt.compile_problem(trajs, tlist, J_T=J_T_sm, device="cpu")
            # a problem compiled for the CPU, explicitly asked onto CUDA
            getattr(gt, entry)(cp, device="cuda")(
                cp.guess_pulsevals.reshape(-1)
            )


def test_kernel_wrappers_refuse_bad_inputs_before_any_launch():
    """The wrappers validate dtype, shape and contiguity for the kernels;
    the checks themselves are plain Python and run here."""
    from grape_tpu_torch.ops.hopper_prop import (
        _check_generator_args, _check_tensor,
    )

    d, T, N = 4, 2, 3
    H0 = torch.zeros((d, d), dtype=torch.complex64)
    ops = torch.zeros((T, d, d), dtype=torch.complex64)
    co = torch.zeros((N, T), dtype=torch.float32)
    dts = torch.zeros((N,), dtype=torch.float32)
    assert _check_generator_args(H0, ops, co, dts) == (T, d, N)
    with pytest.raises(ValueError, match="complex64"):
        _check_generator_args(H0.to(torch.complex128), ops, co, dts)
    with pytest.raises(ValueError, match="float32"):
        _check_generator_args(H0, ops, co.double(), dts)
    with pytest.raises(ValueError, match="shape"):
        _check_generator_args(H0, ops, co, dts[:2])
    with pytest.raises(ValueError, match="contiguous"):
        _check_tensor("x", ops.transpose(1, 2), torch.complex64, (T, d, d),
                      ops.device)
