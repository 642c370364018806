"""On the card: the control (the reference put in the program's place,
computed in complex64 with TF32 products, the precision below the
configuration's) comes out as not correct at each cell's own size, on
three seeds, while the program on the same seeds comes out correct.  A
short window each, about a minute and a half a cell; each seed's readings
are printed (``-s``) as one JSON line."""

import json
import os

import pytest

from benchmark.harness import check, spec

CELLS = [w["name"] for w in json.load(open(os.path.join(
    spec.ROOT, "BENCHMARK.json")))["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(card, cell):
    import torch

    from benchmark import control

    chips = int(spec.cell_spec(cell)["cell"]["chips"])
    if torch.cuda.device_count() < chips:
        pytest.skip(f"the cell takes {chips} cards")
    limits = spec.cell_spec(cell)["check"]["limits"]
    for row in control.readings(cell, [2**31 + 11, 2**31 + 12, 2**31 + 13],
                                6.0):
        print(json.dumps(dict(row, workload=cell)))
        assert row["correct"] is True, row
        assert not check.passes(row["control"], limits), row
