"""The readings that the limits of ``correct`` are set from, for one cell:
on each seed, a short window of the program at the cell's own size, then at
the same iterates the program's compared numbers (the lower readings) and
the control's, the reference in complex64 with TF32 products put in the
program's place (the upper readings).  One JSON line a seed, then one with
the largest program reading and the smallest control reading of each
number.

    python benchmark/control.py --workload <cell> --seeds 1 2 3 --seconds 8

A cell on several cards runs as its ranks, as ``run.py`` runs it
(``harness/ranks.py``), all seeds in one start of them.
"""

import argparse
import json
import os
import subprocess
import sys
import time

T_PROCESS = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    sys.path.pop(0)
sys.path.insert(0, os.path.dirname(HERE))


def readings(workload, seeds, seconds, device="cuda", **kw):
    """``[{"seed", "program": {...}, "control": {...}}]`` of each seed (on
    rank 0; empty on the others where ``kw`` holds ``ranks``).  A cell on
    several cards called without ``ranks`` runs this script, which starts
    its ranks, and reads its lines."""
    from benchmark.harness import cell, spec

    chips = int(spec.cell_spec(workload)["cell"]["chips"])
    if "ranks" not in kw and chips > 1:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--workload",
             workload, "--seeds", *map(str, seeds), "--seconds",
             str(seconds)], capture_output=True, text=True, check=True)
        return [json.loads(t) for t in out.stdout.splitlines()
                if t.startswith('{"seed"')]
    out = []
    for seed in seeds:
        line, _ = cell.run(workload, seed, seconds, False, device=device,
                              control=True, **kw)
        if line is None:
            continue
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
    from benchmark.harness import ranks, spec

    ranks.add_arguments(ap)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    n = int(spec.cell_spec(args.workload)["cell"]["chips"])
    code, rows = ranks.run_ranks(
        n, args, [sys.executable, os.path.abspath(__file__)] + argv,
        lambda group, _: readings(args.workload, args.seeds, args.seconds,
                                  ranks=group),
        t0=T_PROCESS, who="control")
    if rows is None:
        return code
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
