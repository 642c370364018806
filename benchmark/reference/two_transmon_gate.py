"""Reference of a gate on two coupled transmons, for one system or a robust
ensemble of detuning samples.

Each transmon has ``levels`` levels, detuning ``delta`` and anharmonicity
``alpha``; the two share an exchange coupling ``J``; each is driven in both
quadratures, so there are four controls ``eps_l``, piecewise constant on the
``n_steps`` intervals of ``[0, T]``.  The four logical basis states
``|00>, |01>, |10>, |11>`` propagate under ``H_n = H0 + sum_l eps_l[n] H_l``
by ``U_n = exp(-i dt H_n)``; the CZ target flips the sign of ``|11>``.  With
``tau_sk = <target_k | psi_sk(T)>`` the functional is

    J_T = 1 - (1/S) sum_s |(1/4) sum_k tau_sk|^2

over the ``S`` samples (``S = 1``: the square-modulus functional ``J_T_sm``
of the four basis states).  The gradient with respect to the pulse values is
taken by autograd through ``torch.linalg.matrix_exp`` and the state chain:
exact to the working precision, with no series of the program's.
"""

import numpy as np
import torch

__all__ = ["Reference", "operators", "logical_states", "blocks", "combine"]

N_CONTROLS = 4


def _ladder(d):
    a = np.diag(np.sqrt(np.arange(1, d)), 1).astype(np.complex128)
    n = np.diag(np.arange(d)).astype(np.complex128)
    return a, n


def operators(config, detunings):
    """``(H0 (S, D, D), drives (4, D, D))`` complex128 numpy, ``D =
    levels**2``, with sample ``s`` detuned by ``detunings[s]`` (two
    numbers, one a transmon)."""
    d = int(config["levels"])
    a, n = _ladder(d)
    eye = np.eye(d, dtype=np.complex128)
    a1, a2 = np.kron(a, eye), np.kron(eye, a)
    n1, n2 = np.kron(n, eye), np.kron(eye, n)
    c = config
    fixed = (0.5 * c["alpha1"] * (n1 @ n1 - n1)
             + 0.5 * c["alpha2"] * (n2 @ n2 - n2)
             + c["J"] * (a1 @ a2.conj().T + a1.conj().T @ a2))
    H0 = np.stack([
        fixed + (c["delta1"] + dd[0]) * n1 + (c["delta2"] + dd[1]) * n2
        for dd in np.asarray(detunings, dtype=np.float64)])
    drives = np.stack([0.5 * (a1 + a1.conj().T), 0.5j * (a1 - a1.conj().T),
                       0.5 * (a2 + a2.conj().T), 0.5j * (a2 - a2.conj().T)])
    return H0, drives


def logical_states(config):
    """``(initial (4, D), targets (4, D))``: the logical basis and its CZ
    image."""
    d = int(config["levels"])
    initial = np.zeros((4, d * d), dtype=np.complex128)
    for k, (i, j) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        initial[k, i * d + j] = 1.0
    targets = initial * np.array([1.0, 1.0, 1.0, -1.0])[:, None]
    return initial, targets


def blocks(inputs, n):
    """The raw inputs cut into ``n`` blocks of contiguous samples, for a
    reference computed on several cards (an empty block: None).  The
    functional is a mean over the samples, so it splits by sample."""
    det = np.asarray(inputs["detunings"], dtype=np.float64)
    return [{"detunings": b} if len(b) else None
            for b in np.array_split(det, n)]


def combine(blocks, parts):
    """``(J_T, gradient)`` of every sample from each block's ``(J_T,
    gradient)``: ``1 - J_T`` and the gradient are means over the samples,
    so each block weighs by its share of them."""
    sizes = [len(b["detunings"]) for b in blocks]
    total = float(sum(sizes))
    J, g = 1.0, 0.0
    for size, (J_b, g_b) in zip(sizes, parts):
        J -= size / total * (1.0 - J_b)
        g = g + size / total * np.asarray(g_b, dtype=np.float64)
    return J, g


class Reference:
    """``value_and_grad(pulses (4, n_steps))`` of the configuration at
    ``dtype`` (complex128: the reference; complex64 with TF32 products: the
    control), on ``device``.

    The states and the co-states are propagated without autograd; the
    gradient is then taken by autograd one window of ``window_items`` steps
    times samples at a time: in a window ``[n0, n1)`` the overlap
    ``<chi(n1) | U_n1 ... U_n0+1 | psi(n0)>`` equals ``tau``, so its
    derivative is ``tau``'s derivative with respect to the window's pulse
    values.  That keeps the matrices that the backward pass of
    ``matrix_exp`` holds to one window."""

    def __init__(self, config, inputs, device, dtype=torch.complex128,
                 tf32=False, window_items=2000):
        # TF32 is the control's precision only; the reference turns it off
        torch.backends.cuda.matmul.allow_tf32 = bool(tf32)
        torch.backends.cudnn.allow_tf32 = bool(tf32)
        self.device = torch.device(device)
        self.dtype = dtype
        self.rdtype = (torch.float64 if dtype == torch.complex128
                       else torch.float32)
        H0, drives = operators(config, inputs["detunings"])
        initial, targets = logical_states(config)

        def c(x):
            return torch.as_tensor(x, dtype=dtype, device=self.device)

        self.H0, self.drives = c(H0), c(drives)
        self.initial, self.targets = c(initial), c(targets)
        self.n_steps = int(config["n_steps"])
        self.dt = float(config["T"]) / self.n_steps
        S = self.H0.shape[0]
        self.window = max(1, int(window_items) // S)

    def _propagators(self, eps, n0, n1):
        """``U (S, n1-n0, D, D)`` of steps ``n0..n1-1``."""
        H = self.H0[:, None] + torch.einsum(
            "ln,lij->nij", eps[:, n0:n1].to(self.dtype), self.drives)[None]
        return torch.linalg.matrix_exp((-1j * self.dt) * H)

    def value_and_grad(self, pulses):
        """``(J_T, dJ_T/d pulses flattened control-major)`` as float and
        float64 numpy."""
        N, W = self.n_steps, self.window
        eps = torch.tensor(np.asarray(pulses, dtype=np.float64),
                           dtype=self.rdtype, device=self.device)
        S = self.H0.shape[0]
        starts = list(range(0, N, W))
        # psi(n0) at each window's start, then chi(n1) at each window's end
        psi = self.initial.T.expand(S, -1, -1).contiguous()  # (S, D, 4)
        psi_at = {}
        with torch.no_grad():
            for n0 in starts:
                psi_at[n0] = psi
                U = self._propagators(eps, n0, min(n0 + W, N))
                for j in range(U.shape[1]):
                    psi = U[:, j] @ psi
            tau = torch.einsum("kd,sdk->sk", self.targets.conj(), psi)
            F = tau.mean(dim=-1)  # (S,)
            chi = self.targets.T.expand(S, -1, -1).contiguous()
            chi_at = {}
            for n0 in reversed(starts):
                n1 = min(n0 + W, N)
                chi_at[n1] = chi
                U = self._propagators(eps, n0, n1)
                for j in reversed(range(U.shape[1])):
                    chi = U[:, j].conj().transpose(-1, -2) @ chi
            del U
        grad = torch.zeros_like(eps)
        for n0 in starts:
            n1 = min(n0 + W, N)
            e = eps.detach().clone().requires_grad_(True)
            U = self._propagators(e, n0, n1)
            x = psi_at[n0]
            for j in range(U.shape[1]):
                x = U[:, j] @ x
            f = torch.einsum("sdk,sdk->s", chi_at[n1].conj(), x) / 4.0
            # d|F_s|^2 = 2 Re(conj(F_s) dF_s), with F_s held fixed
            torch.sum(torch.real(F.conj() * f)).backward()
            grad += e.grad
            del U, x, f, e
        J = 1.0 - float(torch.mean(torch.abs(F) ** 2))
        g = (-2.0 / S) * grad.to(torch.float64).cpu().numpy()
        return J, g.reshape(-1)
