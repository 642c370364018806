"""Find a cell's files by the names in ``BENCHMARK.json``.

- ``BENCHMARK.json`` (at the checkout's root): the cell's entry, its
  configuration's entry and the metrics that the cell reports;
- the configuration's ``file``: the physics, ``source``, ``reduced``;
- ``benchmark/traffic/<traffic>.json``: the job (the program's options,
  the bounds, how the seed draws the guesses, the solve cap);
- ``benchmark/workloads/<cell>.json``: which iterates are checked, the
  limits of the comparison and the profiled slice of a traced run.
"""

import json
import os

__all__ = ["ROOT", "BENCH_DIR", "load_json", "cell_spec"]

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def _applies(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def cell_spec(name, root=ROOT):
    """Everything the harness reads for cell ``name``, as one dict."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json "
                       f"(cells: {sorted(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[cell["config"]]
    return {
        "name": name,
        "cell": cell,
        "config": load_json(os.path.join(root, entry["file"])),
        "traffic": load_json(os.path.join(
            BENCH_DIR, "traffic", cell["traffic"] + ".json")),
        "check": load_json(os.path.join(
            BENCH_DIR, "workloads", name + ".json")),
        "end_to_end": [m for m in bench["end_to_end"] if _applies(m, name)],
        "per_layer": [m for m in bench["per_layer"] if _applies(m, name)],
        "run_seconds": bench["run_seconds"],
    }
