"""pytest settings of the benchmark's own tests (``python -m pytest
benchmark/tests -q``).  Tests marked ``card`` need an NVIDIA card; whether
there is one is decided inside the ``card`` fixture, never while a module
is imported."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    """Skips the test where no CUDA card is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels run only there")
    return torch.device("cuda")


@pytest.fixture
def no_card():
    """Skips the test where a CUDA card is present."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a card")
