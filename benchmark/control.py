"""The readings that the limits of ``correct`` are set from, for one cell:
on each seed, a short window of the program at the cell's own size, then at
the same iterates the program's compared numbers (the lower readings) and
the control's, the reference in complex64 with TF32 products put in the
program's place (the upper readings).  One JSON line a seed, then one with
the largest program reading and the smallest control reading of each
number.

    python benchmark/control.py --workload <cell> --seeds 1 2 3 --seconds 8
"""

import argparse
import json
import os
import sys
import time

T_PROCESS = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    sys.path.pop(0)
sys.path.insert(0, os.path.dirname(HERE))


def readings(workload, seeds, seconds, device="cuda", **kw):
    """``[{"seed", "program": {...}, "control": {...}}]`` of each seed."""
    from benchmark.harness import cell

    out = []
    for seed in seeds:
        line, _ = cell.run(workload, seed, seconds, False, device=device,
                              control=True, **kw)
        out.append({"seed": seed, "correct": line["correct"],
                    "program": {k: v["value"]
                                for k, v in line["checks"].items()},
                    "control": line["control"],
                    "attempted": line["attempted"],
                    "failed": line["failed"]})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    rows = readings(args.workload, args.seeds, args.seconds)
    for row in rows:
        print(json.dumps(row), flush=True)
    keys = rows[0]["program"].keys()
    print(json.dumps({
        "workload": args.workload,
        "lower": {k: max(r["program"][k] for r in rows) for k in keys},
        "upper": {k: min(r["control"][k] for r in rows) for k in keys},
        "seconds": time.perf_counter() - T_PROCESS}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
