"""A later change adds a configuration of a new kind, its traffic, its cell
and metrics as new files and new entries only: here, in a copy of the
benchmark, a gate on one transmon (two controls, two basis states in one
generator group, a traffic that names its own optimizer), run on the CPU
(the harness's look for a card skipped), untraced and traced.  No file of
the copy that was there before is changed."""

import filecmp
import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from benchmark.harness import spec

KIND = "transmon_x_gate"
CELL = "x.scipy"

PROGRAM = '''
"""An X gate on the lowest two levels of one transmon, posed to the
program: two quadrature controls, the two basis states under one
generator, ``J_T_sm``."""

import numpy as np


def draw(config, seed):
    return {}


def guess(config, traffic, r):
    N = int(config["n_steps"])
    t = np.linspace(0.0, 1.0, N)
    env = np.sin(np.pi * t) ** 2
    out = np.stack([env * (1.0 + 0.1 * r.normal()), 0.2 * env * r.normal()])
    return out * float(traffic["guess"]["amplitude"])


def operators(config):
    d = int(config["levels"])
    a = np.diag(np.sqrt(np.arange(1, d)), 1).astype(complex)
    n = a.conj().T @ a
    H0 = 0.5 * config["alpha"] * (n @ n - n)
    return H0, [0.5 * (a + a.conj().T), 0.5j * (a - a.conj().T)]


class Program:
    def __init__(self, config, inputs):
        self.H0, self.drives = operators(config)
        self.tlist = np.linspace(0.0, config["T"], config["n_steps"] + 1)

    def structure(self):
        one = lambda M: float(np.max(np.sum(np.abs(M), axis=-2)))
        N_T = len(self.tlist) - 1
        return {"d": self.H0.shape[0], "G": 1, "gs": 2, "K": 2, "T": 2,
                "L": 2, "N_T": N_T, "dt": float(self.tlist[-1]) / N_T,
                "h0_norm": one(self.H0),
                "op_norms": [one(H) for H in self.drives]}

    def problem(self, pulses):
        from grape_tpu_torch import ControlProblem, Trajectory, hamiltonian
        from grape_tpu_torch.functionals import J_T_sm

        H = hamiltonian(self.H0, *zip(self.drives,
                                      [np.array(p) for p in pulses]))
        d = self.H0.shape[0]
        e = np.eye(d, dtype=complex)
        return ControlProblem([Trajectory(e[0], H, target_state=e[1]),
                               Trajectory(e[1], H, target_state=e[0])],
                              self.tlist, J_T=J_T_sm)
'''

REFERENCE = '''
"""Plain reference of an X gate on one transmon: autograd through
``matrix_exp`` over every step."""

import numpy as np
import torch


class Reference:
    def __init__(self, config, inputs, device, dtype=torch.complex128,
                 tf32=False):
        torch.backends.cuda.matmul.allow_tf32 = bool(tf32)
        d = int(config["levels"])
        a = np.diag(np.sqrt(np.arange(1, d)), 1).astype(complex)
        n = a.conj().T @ a
        c = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
        self.H0 = c(0.5 * config["alpha"] * (n @ n - n))
        self.drives = c(np.stack([0.5 * (a + a.conj().T),
                                  0.5j * (a - a.conj().T)]))
        e = np.eye(d, dtype=complex)
        self.psi0, self.targets = c(e[:, :2]), c(e[:, [1, 0]])
        self.dt = config["T"] / config["n_steps"]
        self.device = device

    def value_and_grad(self, pulses):
        eps = torch.tensor(np.asarray(pulses), dtype=torch.float64,
                           device=self.device, requires_grad=True)
        H = self.H0 + torch.einsum("ln,lij->nij",
                                   eps.to(self.H0.dtype), self.drives)
        U = torch.linalg.matrix_exp(-1j * self.dt * H)
        psi = self.psi0
        for j in range(U.shape[0]):
            psi = U[j] @ psi
        tau = torch.sum(self.targets.conj() * psi, dim=0)
        J = 1.0 - torch.abs(tau.mean()) ** 2
        J.backward()
        return float(J), eps.grad.numpy().reshape(-1)
'''

FILES = {
    f"configs/x_transmon.json": {
        "name": "x_transmon", "kind": KIND,
        "source": "https://example.org/one-transmon-x-gate",
        "levels": 3, "alpha": -0.3, "T": 20.0, "n_steps": 40,
        "functional": "J_T_sm", "dtype": "complex128", "reduced": []},
    f"traffic/x_scipy.json": {
        "optimizer": "scipy-lbfgsb",
        "options": {"gradient_method": "gradgen"}, "bounds": None,
        "guess": {"amplitude": 0.1, "pool": 2},
        "solve_iter_stop": 40, "warmup_iter_stop": 2},
    f"workloads/{CELL}.json": {
        "checked_iterates": {"random": 2, "last": True},
        "path_iterations": 3,
        "limits": {"J_T_gap": 1e-8, "grad_gap": 1e-6, "J_T_rise": 0.0,
                   "path_J_gap": 1e-8, "path_x_gap": 1e-5},
        "trace_slice": {"start_share": 0.3, "seconds": 0.2,
                        "min_iterations": 2}},
}

ENTRIES = {
    "configs": {"name": "x_transmon",
                "source": "https://example.org/one-transmon-x-gate",
                "file": "benchmark/configs/x_transmon.json", "reduced": [],
                "why": "a second kind of problem"},
    "workloads": {"name": CELL, "config": "x_transmon",
                  "traffic": "x_scipy", "chips": 1,
                  "why": "X gate solves through scipy's L-BFGS-B"},
    "end_to_end": {"name": "iters_per_s.x", "unit": "iter/s",
                   "better": "higher", "bound": 0.05,
                   "source": "host_clock", "workloads": [CELL]},
    "per_layer": {"name": "eval_ms.x", "unit": "ms", "better": "lower",
                  "source": "host_clock", "layer": "evaluation",
                  "moves": "iters_per_s.x", "workloads": [CELL]},
}

RUN = textwrap.dedent('''
    import json, sys
    import torch
    torch.set_num_threads(1)
    from benchmark.harness import cell
    line, lines = cell.run({cell!r}, 2**31 + 5, 1.0, {trace}, device="cpu")
    print(json.dumps(line))
''')


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(spec.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))
    for key, entry in ENTRIES.items():
        bench[key].append(entry)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    for rel, data in FILES.items():
        path = root / "benchmark" / rel
        assert not path.exists()
        path.write_text(json.dumps(data))
    for rel, text in ((f"programs/{KIND}.py", PROGRAM),
                      (f"reference/{KIND}.py", REFERENCE)):
        path = root / "benchmark" / rel
        assert not path.exists()
        path.write_text(text)
    return root


def _run(root, trace):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root), spec.ROOT]))
    out = subprocess.run(
        [sys.executable, "-c", RUN.format(cell=CELL, trace=trace)],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [False, True])
def test_a_new_kind_runs_from_new_files_only(copy, trace):
    line = _run(copy, trace)
    assert line["correct"] is True, line
    assert set(line["checks"]) == set(
        FILES[f"workloads/{CELL}.json"]["limits"])
    if trace:
        assert set(line["metrics"]) == {"eval_ms.x"}
    else:
        assert set(line["metrics"]) == {"setup_s", "iters_per_s.x"}
    # the files that were there are the same, byte for byte
    cmp = filecmp.dircmp(spec.BENCH_DIR, copy / "benchmark",
                         ignore=["__pycache__"])

    def changed(c):
        return c.diff_files + [f for sub in c.subdirs.values()
                               for f in changed(sub)]

    assert not changed(cmp)
