"""A gate on two coupled transmons at a truncation large enough that the
program propagates by a Chebyshev series of products with the generator
(no step exponential is formed), posed to ``grape_tpu_torch`` as
``two_transmon_gate`` poses it.  The kind extends that one by import: the
same draws, guesses, operators and problem; its counted structure adds
what the series' term count needs.

- ``h0_range``: the lowest and the highest eigenvalue of the drift (over
  the samples), from ``numpy.linalg.eigvalsh`` once at set-up;
- ``op_radii``: each drive's 2-norm (its spectral radius: the drives are
  Hermitian).

With them ``counts/cheby.py`` bounds the spectrum of every step's
generator at an evaluation's own amplitudes."""

import numpy as np

from benchmark.programs import two_transmon_gate as base

__all__ = ["draw", "guess", "Program"]

draw = base.draw
guess = base.guess


class Program(base.Program):
    def structure(self):
        out = super().structure()
        lo, hi = np.inf, -np.inf
        for H in self.H0:
            w = np.linalg.eigvalsh(0.5 * (H + H.conj().T))
            lo, hi = min(lo, float(w[0])), max(hi, float(w[-1]))
        out["h0_range"] = [lo, hi]
        # the drives are Hermitian: the 2-norm is the largest |eigenvalue|
        out["op_radii"] = [float(np.max(np.abs(np.linalg.eigvalsh(H))))
                           for H in self.drives]
        return out
