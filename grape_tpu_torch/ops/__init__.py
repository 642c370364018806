"""Numerical building blocks: plain PyTorch matrix functions (``expm``,
``frechet``), the Chebyshev and Krylov series (``cheby``, ``newton``) and
the hand-written CUDA kernels with their wrappers (``hopper_prop``,
``hopper_frechet``, ``hopper_cheby``, and the probe's ``hopper_matmul``;
built by ``_build``).

A kernel wrapper takes its plain PyTorch version only for a CPU tensor.
:func:`plain_versions` is the one explicit exception, a switch for tests
and for ``chip_smoke.py``, which hold a kernel against its plain version on
the same CUDA tensors; nothing in the package turns it on.
"""

import contextlib

_force_plain = False


def plain_forced():
    """True inside a :func:`plain_versions` block."""
    return _force_plain


@contextlib.contextmanager
def plain_versions():
    """Within the block, every kernel wrapper runs its plain PyTorch
    version, also on CUDA tensors (test-only)."""
    global _force_plain
    old = _force_plain
    _force_plain = True
    try:
        yield
    finally:
        _force_plain = old
