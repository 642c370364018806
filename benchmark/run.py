"""The benchmark of grape_tpu_torch: one run of one cell.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA card.  The cell,
its configuration, its traffic and its limits are found by name from
``BENCHMARK.json``.  Prints, as its last line on standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``
(with ``--trace 1`` also ``busy_s`` and ``window_s``), ``breakdown`` (traced
runs) and ``checks`` (each compared number and its limit, also the last
lines on standard error).  Exits 2 without printing a result where the
machine has no CUDA card or fewer than the cell asks for, and 3 where a
module of JAX or of the JAX package was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the checkout's root, so that the program's package and this one import;
# and not this folder, whose names would shadow the standard library's
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    sys.path.pop(0)
sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.harness import spec

    cell = spec.cell_spec(args.workload)["cell"]
    import torch

    t_torch = time.perf_counter()
    if not torch.cuda.is_available():
        print("benchmark: no CUDA card on this machine "
              "(torch.cuda.is_available() is False); the benchmark runs "
              "only on the card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"benchmark: the cell asks for {cell['chips']} cards, the "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2

    from benchmark.harness import cell as cell_run

    line, lines = cell_run.run(args.workload, args.seed, args.seconds,
                                  bool(args.trace), device="cuda",
                                  t0=T_PROCESS, t_torch=t_torch)
    loaded = sorted({m.split(".")[0] for m in list(sys.modules)}
                    & set(cell_run.FORBIDDEN))
    if loaded:
        print(f"benchmark: the measuring process loaded {loaded}",
              file=sys.stderr)
        return 3
    for text in lines:
        print(text, file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
