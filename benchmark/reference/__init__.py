"""Plain PyTorch reference of the benchmark's configurations.

One module per configuration kind (the ``kind`` of a configuration file),
each with a ``Reference(config, inputs, device, dtype)`` whose
``value_and_grad(pulses)`` gives the functional and its gradient at a pulse.
The reference imports nothing of the program under test: it builds the
Hamiltonians, the states, the targets and the functional itself from the
configuration file and the raw inputs that the harness draws from the seed.
"""

import importlib

__all__ = ["load"]


def load(kind):
    """The reference module of configuration kind ``kind``."""
    return importlib.import_module(f"{__name__}.{kind}")
