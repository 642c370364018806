"""A cell at a size the CPU runs in seconds: dim 9, 40 steps, 2 samples,
the program in complex128.  T = 20, so that the controls move J_T within
an iteration or two and a wrong step shows in the path."""

import numpy as np

from benchmark.harness import cell, spec


def config(name, samples=2):
    cfg = dict(spec.cell_spec(name)["config"], levels=3, n_steps=40, T=20.0)
    if cfg["n_samples"] > 1:
        cfg["n_samples"] = samples
    return cfg


def run(name, seed=2**31 + 3, seconds=1.0, trace=False):
    import torch

    torch.set_num_threads(1)
    return cell.run(name, seed, seconds, trace, device="cpu",
                    config=config(name), dtype=np.complex128)
