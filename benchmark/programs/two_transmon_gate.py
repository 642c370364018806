"""A gate on two coupled transmons, posed to ``grape_tpu_torch``: one
``hamiltonian`` a sample over the four shared controls, the four logical
basis states of each sample as ``Trajectory`` objects (sample-major), and
the configuration's functional (``J_T_sm``, or the ensemble's
per-sample-coherent functional).  The operators are built here, in numpy,
from the configuration and the seed's detunings."""

import numpy as np

from benchmark.harness.inputs import rng

__all__ = ["draw", "guess", "flattop", "Program"]

N_CONTROLS = 4
N_BASIS = 4  # the logical basis states of a sample: one generator group


def draw(config, seed):
    """The ensemble's detunings, one pair a sample.  The card's samples are
    one draw, the same for every seed; the seed orders them."""
    S = int(config["n_samples"])
    spread = float(config["delta_spread"])
    samples = rng(0, 1).uniform(-spread, spread, size=(S, 2))
    return {"detunings": samples[rng(seed, 1).permutation(S)]}


def flattop(t, T, t_rise):
    """Blackman-ramped flat-top envelope on ``[0, T]``."""
    t = np.asarray(t, dtype=np.float64)

    def blackman_ramp(x):  # rises from 0 to 1 over x in [0, 1]
        x = np.clip(x, 0.0, 1.0)
        return 0.42 - 0.5 * np.cos(np.pi * x) + 0.08 * np.cos(2 * np.pi * x)

    return blackman_ramp(t / t_rise) * blackman_ramp((T - t) / t_rise)


def guess(config, traffic, r):
    """``(4, n_steps)`` pulse values on the intervals (the first and last
    at ``t = 0`` and ``t = T``, the program's midpoint convention).  The x
    quadratures (controls 0, 2) are the envelope times ``1 + x_noise *
    r(t)``, the y quadratures (1, 3) the envelope times ``r(t)``, with
    ``r`` a random sum of ``modes`` sines; each control is then scaled to
    the peak ``amplitude`` (x) or ``y_share * amplitude`` (y)."""
    g = traffic["guess"]
    T, N = float(config["T"]), int(config["n_steps"])
    tl = np.linspace(0.0, T, N + 1)
    mid = 0.5 * (tl[1:] + tl[:-1])
    mid[0], mid[-1] = tl[0], tl[-1]
    env = flattop(mid, T, float(g["t_rise"]))
    M = int(g["modes"])
    modes = np.sin(np.pi * np.outer(np.arange(1, M + 1), mid) / T)  # (M, N)
    out = np.empty((N_CONTROLS, N))
    for l in range(N_CONTROLS):
        series = r.normal(size=M) @ modes / np.sqrt(M)
        if l % 2 == 0:
            shape, peak = 1.0 + float(g["x_noise"]) * series, 1.0
        else:
            shape, peak = series, float(g["y_share"])
        p = env * shape
        out[l] = p * (float(g["amplitude"]) * peak / np.max(np.abs(p)))
    return out


def _ladder(d):
    a = np.diag(np.sqrt(np.arange(1, d)), 1).astype(complex)
    n = np.diag(np.arange(d)).astype(complex)
    return a, n


def _one_norm(M):
    return float(np.max(np.sum(np.abs(M), axis=-2)))


class Program:
    def __init__(self, config, inputs):
        c = config
        d = int(c["levels"])
        a, n = _ladder(d)
        eye = np.eye(d, dtype=complex)
        a1, a2 = np.kron(a, eye), np.kron(eye, a)
        n1, n2 = np.kron(n, eye), np.kron(eye, n)
        self.drives = [0.5 * (a1 + a1.conj().T), 0.5j * (a1 - a1.conj().T),
                       0.5 * (a2 + a2.conj().T), 0.5j * (a2 - a2.conj().T)]
        self.H0 = []
        for d1, d2 in np.asarray(inputs["detunings"], dtype=np.float64):
            self.H0.append(
                (c["delta1"] + d1) * n1 + 0.5 * c["alpha1"] * (n1 @ n1 - n1)
                + (c["delta2"] + d2) * n2 + 0.5 * c["alpha2"] * (n2 @ n2 - n2)
                + c["J"] * (a1 @ a2.conj().T + a1.conj().T @ a2))
        dim = d * d
        self.basis = []
        for i, j in ((0, 0), (0, 1), (1, 0), (1, 1)):
            v = np.zeros(dim, dtype=complex)
            v[i * d + j] = 1.0
            self.basis.append(v)
        self.phases = [1.0, 1.0, 1.0, -1.0]
        self.tlist = np.linspace(0.0, float(c["T"]), int(c["n_steps"]) + 1)
        self.functional = c["functional"]

    def structure(self):
        """The counted shapes: each sample one generator group of its four
        basis states."""
        S, N_T = len(self.H0), len(self.tlist) - 1
        return {
            "d": int(self.H0[0].shape[0]), "G": S, "gs": N_BASIS,
            "K": N_BASIS * S, "T": len(self.drives), "L": len(self.drives),
            "N_T": N_T, "dt": float(self.tlist[-1]) / N_T,
            "h0_norm": max(_one_norm(H) for H in self.H0),
            "op_norms": [_one_norm(H) for H in self.drives],
        }

    def problem(self, pulses):
        """The ``ControlProblem`` of one solve from the guess ``pulses (4,
        n_steps)``: each row one control, shared by every sample."""
        from grape_tpu_torch import ControlProblem, Trajectory, hamiltonian
        from grape_tpu_torch.functionals import (
            J_T_sm, make_ensemble_gate_functional,
        )

        controls = [np.array(p, dtype=np.float64) for p in pulses]
        trajectories = []
        for H0 in self.H0:
            H = hamiltonian(H0, *zip(self.drives, controls))
            for b, ph in zip(self.basis, self.phases):
                trajectories.append(Trajectory(b, H, target_state=ph * b))
        if self.functional == "J_T_sm":
            J_T = J_T_sm
        elif self.functional == "ensemble_sm":
            J_T = make_ensemble_gate_functional(N_BASIS)
        else:
            raise ValueError(f"unknown functional {self.functional!r}")
        return ControlProblem(trajectories, self.tlist, J_T=J_T)
