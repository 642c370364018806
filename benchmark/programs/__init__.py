"""How the benchmark poses each configuration kind to the program under
test (``grape_tpu_torch``), one module per kind (the ``kind`` of a
configuration file).  A kind's module provides:

- ``draw(config, seed)``: the raw inputs that both the program and the
  reference get (for an ensemble, its samples), the same for every seed up
  to their order;
- ``guess(config, traffic, rng)``: one guess, ``(n_controls, n_steps)``
  pulse values drawn from the numpy generator ``rng`` by the traffic's
  ``guess`` parameters;
- ``Program(config, inputs)``: builds the static operators once;
  ``problem(pulses)`` poses one solve from a guess through the program's
  public API, and ``structure()`` gives the counted shapes that the
  operation counts of ``benchmark/counts`` read (``d``, ``G`` generator
  groups of ``gs`` trajectories, ``K``, ``T`` and ``L`` controls,
  ``N_T``, ``dt``, the operators' one-norms)."""

import importlib

__all__ = ["load"]


def load(kind):
    """The program-side module of configuration kind ``kind``."""
    return importlib.import_module(f"{__name__}.{kind}")
