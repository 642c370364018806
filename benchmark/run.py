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
machine has no CUDA card or fewer than the cell asks for, 3 where a
module of JAX or of the JAX package was loaded in any rank's process, and
5 where one of a cell's ranks failed.

A cell with ``chips`` = N > 1 runs as N ranks on this host
(``harness/ranks.py``): this process is rank 0 and starts the others as
copies of itself with ``--rank`` and ``--rendezvous``, which only it
passes.
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


def main(argv=None, device="cuda", command=None, world=None,
         **run_kwargs):
    """One run; the result line printed by rank 0.  ``device``, ``world``
    (the ranks, instead of the cell's ``chips``) and ``run_kwargs``
    (``harness.cell.run``'s ``config`` and ``dtype``) are the CPU tests';
    ``command`` is what starts the other ranks (this script)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    from benchmark.harness import ranks, spec

    ranks.add_arguments(ap)
    args = ap.parse_args(argv)
    # torch's own cache of the kernels it compiles at run time (complex
    # elementwise operations), at a fixed place inside the checkout; torch
    # creates only the last directory of the path, so it is made here
    os.environ.setdefault("PYTORCH_KERNEL_CACHE_PATH",
                          os.path.join(ROOT, "build", "torch_kernels"))
    os.makedirs(os.environ["PYTORCH_KERNEL_CACHE_PATH"], exist_ok=True)

    def body(group, t_torch):
        from benchmark.harness import cell as cell_run

        return cell_run.run(args.workload, args.seed, args.seconds,
                            bool(args.trace), device=device, t0=T_PROCESS,
                            t_torch=t_torch, ranks=group, **run_kwargs)

    n = int(world or spec.cell_spec(args.workload)["cell"]["chips"])
    # rank 0 starts the others before it imports torch, which they do too
    code, out = ranks.run_ranks(
        n, args, (command or [sys.executable, os.path.abspath(__file__)])
        + argv, body, device=device, t0=T_PROCESS)
    if out is None:
        return code
    line, lines = out
    for text in lines:
        print(text, file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
