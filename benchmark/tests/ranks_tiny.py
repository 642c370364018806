"""A cell on several cards, run on the CPU at the tiny size of ``tiny.py``
(one sample a rank, the program in complex128) as a gloo world of
``--world`` processes: ``benchmark/run.py``'s ``main`` with the look for a
card skipped.  ``--fault`` plants one fault in one rank:

- ``drop_gradient:<r>``: rank r's block of the gradient left out of the
  sum (its share of the all-reduce zeroed);
- ``die:<r>:<i>``: rank r killed at the window's iteration i;
- ``load_jax:<r>``: a stub module named ``jax`` put into rank r's
  ``sys.modules`` at the window's first iteration;
- ``program:<name>``: on every rank, fault ``<name>`` of
  ``test_bench_faults.FAULTS`` planted in the program.

    python -m benchmark.tests.ranks_tiny --world 2 --workload <cell> \\
        --seed <n> --seconds <s> --trace 0
"""

import argparse
import os
import signal
import sys
import types

import numpy as np


class _Patch:
    """What ``test_bench_faults.FAULTS`` take of pytest's ``monkeypatch``."""

    @staticmethod
    def setattr(owner, name, value):
        setattr(owner, name, value)


def plant(fault, rank):
    kind, _, rest = fault.partition(":")
    if kind == "program":
        from benchmark.tests.test_bench_faults import FAULTS

        FAULTS[rest](_Patch())
        return
    target, _, arg = rest.partition(":")
    if int(target) != rank:
        return
    if kind == "drop_gradient":
        from grape_tpu_torch.parallel import mesh

        original = mesh._TrajReduce.reduce

        def reduce(self, lead, summed, vector=None):
            return original(self, lead, summed, None if vector is None
                            else vector.new_zeros(vector.shape))

        mesh._TrajReduce.reduce = reduce
    elif kind == "die":
        from benchmark.harness import window

        original = window.Window.callback

        def callback(self, wrk, iteration):
            if self.n_iters >= int(arg):
                os.kill(os.getpid(), signal.SIGKILL)
            return original(self, wrk, iteration)

        window.Window.callback = callback
    elif kind == "load_jax":
        from benchmark.harness import window

        original = window.Window.callback

        def callback(self, wrk, iteration):
            sys.modules.setdefault("jax", types.ModuleType("jax"))
            return original(self, wrk, iteration)

        window.Window.callback = callback
    else:
        raise ValueError(fault)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--fault", default="")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--workload", required=True)
    own, rest = ap.parse_known_args(argv)
    from benchmark import run
    from benchmark.tests import tiny

    if own.fault:
        plant(own.fault, own.rank)
    command = [sys.executable, "-m", "benchmark.tests.ranks_tiny",
               "--world", str(own.world), "--fault", own.fault]
    rest += ["--workload", own.workload]
    if own.rank:
        rest += ["--rank", str(own.rank)]
    return run.main(rest, device="cpu", command=command, world=own.world,
                    config=tiny.config(own.workload, samples=own.world),
                    dtype=np.complex128)


if __name__ == "__main__":
    sys.exit(main())
