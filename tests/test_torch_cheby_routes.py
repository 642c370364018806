"""The routing rule and layout of the Chebyshev scan's two kernels
(``grape_tpu_torch.ops.hopper_cheby.cheby_route``) and the lane fold of
the ring kernel, on the CPU.

The rule is pure Python, the same on the CPU and on the card, and decides
which CUDA kernel ``cheby_scan`` launches: the ring kernel
(``csrc/cheby_ring.cu``: a persistent grid that hands each vector of the
series point to point through a ring of global slots behind per-block
flags) where its register tile holds a CTA's rows and its shared memory
fits, else the grid-barrier kernel (``csrc/cheby_scan.cu``).  The cases
cover every shape that ``chip_smoke.py`` runs the scan at
(``kernel_check_cheby``, ``cheby_routes``, ``cluster_phase_clock``) and
ragged ones.  No arithmetic changes with the route, so the plain version
the CPU runs is the same for both (``tests/test_torch_cheby_kernel_plain.py``
holds it against the reference)."""

import numpy as np
import pytest

from grape_tpu_torch.ops import hopper_cheby as hc

# one H100 SXM
SMS = 132
SMEM_MAX = 232448

PLANS = [
    # (d, K): (route, rows, blocks, tr, tk, wk, chunks, smem)
    # the three Chebyshev paths: the CZ, the subspace gate, dim 256
    ((1024, 4), ("ring", 8, 128, 8, 4, 1, 1, 136064)),
    ((1024, 64), ("ring", 8, 128, 8, 4, 8, 2, 147584)),
    ((256, 4), ("ring", 2, 128, 2, 4, 1, 1, 9536)),
    # cheby_routes: K = 1 and 8 at dim 1024, the ring's last d, past it
    ((1024, 1), ("ring", 8, 128, 8, 1, 1, 1, 132416)),
    ((1024, 8), ("ring", 8, 128, 8, 4, 2, 1, 136832)),
    ((1056, 4), ("ring", 8, 132, 8, 4, 1, 1, 140160)),
    ((1100, 4), ("grid", 9, 123, 8, 4, 1, 1, 145888)),
    # kernel_check_cheby's ragged shapes
    ((257, 3), ("ring", 2, 129, 2, 4, 1, 1, 9520)),
    ((300, 1), ("ring", 3, 100, 4, 1, 1, 1, 19912)),
    ((1000, 5), ("ring", 8, 125, 8, 4, 2, 1, 133184)),
    ((300, 3), ("ring", 3, 100, 4, 4, 1, 1, 21592)),
    ((257, 5), ("ring", 2, 129, 2, 4, 2, 1, 9616)),
    ((1000, 1), ("ring", 8, 125, 8, 1, 1, 1, 129344)),
    ((1024, 16), ("ring", 8, 128, 8, 4, 4, 1, 138368)),
    ((1024, 100), ("ring", 8, 128, 8, 4, 8, 4, 154496)),
    ((129, 9), ("ring", 1, 129, 2, 4, 4, 1, 5496)),
    ((1100, 3), ("grid", 9, 123, 8, 4, 1, 1, 145672)),
    # the ceiling of the gate (CHEBY_MAX_DIM) and a K whose slab state
    # does not fit: the grid kernel; the largest K that still fits
    ((1536, 4), ("grid", 12, 128, 8, 4, 1, 1, 201984)),
    ((1024, 506), ("ring", 8, 128, 8, 4, 8, 16, 232448)),
    ((1024, 507), ("grid", 8, 128, 8, 4, 8, 16, 232640)),
    ((1024, 1024), ("grid", 8, 128, 8, 4, 8, 32, 331904)),
]


@pytest.mark.parametrize("shape,plan", PLANS,
                         ids=[f"d{d}-K{K}" for (d, K), _ in PLANS])
def test_cheby_route(shape, plan):
    got = hc.cheby_route(*shape, SMS)
    assert (got["route"], got["rows"], got["blocks"], got["tr"], got["tk"],
            got["wk"], got["chunks"], got["smem"]) == plan
    assert got["wj"] * got["wk"] == hc.RING_WARPS


def test_ring_smem_is_the_kernel_layout():
    """128 bytes of mbarriers, two buffers of tr rows in two float planes,
    three (K, rows) complex state arrays, two fold buffers of a tr x tk
    tile per compute warp: at the CZ's shape 136,064 bytes."""
    assert hc._ring_smem(1024, 4, 8, 8, 4) == (
        128 + 2 * 2 * 8 * 1024 * 4 + 3 * 4 * 8 * 8 + 2 * 8 * 8 * 4 * 8)
    assert hc._ring_smem(1024, 4, 8, 8, 4) == 136064


def _shapes():
    rng = np.random.default_rng(3)
    for _ in range(400):
        yield int(rng.integers(1, 1600)), int(rng.integers(1, 700))


def test_cheby_route_invariants():
    """Every CTA owns rows (the last one at least one), the rows fit the
    register tile, every trajectory falls in a warp's tile, one CTA per SM
    at most, and the ring layout fits one CTA's shared memory; the grid
    kernel exactly where it does not."""
    for d, K in _shapes():
        p = hc.cheby_route(d, K, SMS)
        rows, blocks = p["rows"], p["blocks"]
        assert (blocks - 1) * rows < d <= blocks * rows <= d + rows - 1
        assert blocks <= SMS
        assert p["tr"] in (2, 4, 8) and p["tk"] == (1 if K == 1 else 4)
        assert p["wk"] in (1, 2, 4, 8) and p["wj"] == 8 // p["wk"]
        assert p["tk"] * p["wk"] * p["chunks"] >= K
        assert p["tk"] * p["wk"] * (p["chunks"] - 1) < K
        assert p["smem"] == hc._ring_smem(d, K, rows, p["tr"], p["tk"])
        fits = rows <= p["tr"] and rows <= hc.RING_MAX_ROWS \
            and p["smem"] <= SMEM_MAX
        assert p["route"] == ("ring" if fits else "grid")


def test_ring_depth_and_flags():
    """Two global slots of (K, d) and one flag per (block, k-group), each on
    its own 128-byte line."""
    assert hc.RING_SLOTS == 2
    assert hc.RING_FLAG_STRIDE * 4 == 128


def test_every_ring_dimension_up_to_eight_rows_per_sm():
    """At K = 4 the ring kernel takes every d of the gate (256..1536) up to
    8 rows per SM, 1056 on 132 SMs, and the grid kernel the rest."""
    routes = [hc.cheby_route(d, 4, SMS)["route"] for d in range(256, 1537)]
    assert routes == ["ring"] * (1056 - 255) + ["grid"] * (1536 - 1056)
    assert hc.cheby_route(1056, 4, 100)["route"] == "grid"  # 11 rows


def test_forced_route_restores():
    assert hc._forced == {"route": None}
    with hc._forced_route("grid"):
        assert hc._forced == {"route": "grid"}
        with hc._forced_route("ring"):
            assert hc._forced == {"route": "ring"}
        assert hc._forced == {"route": "grid"}
    assert hc._forced == {"route": None}


def _fold(values):
    """The ring kernel's fold (``fold_level`` / ``fold`` in
    ``csrc/cheby_ring.cu``) on 32 lanes: ``values (32, C0)`` complex; at
    each level (lane bit 16, 8, 4, 2, 1) a lane holding C > 1 values keeps
    the upper half if its bit is set, else the lower, and adds its
    partner's copy of that half; at C = 1 a butterfly sum."""
    v = [list(row) for row in values]
    for o in (16, 8, 4, 2, 1):
        c = len(v[0])
        new = []
        for lane in range(32):
            partner = v[lane ^ o]
            if c > 1:
                h = c // 2
                upper = bool(lane & o)
                keep = v[lane][h:] if upper else v[lane][:h]
                recv = partner[h:] if upper else partner[:h]
                new.append([a + b for a, b in zip(keep, recv)])
            else:
                new.append([v[lane][0] + partner[0]])
        v = new
    return v


@pytest.mark.parametrize("tr,tk", [(2, 1), (2, 4), (4, 1), (4, 4), (8, 1),
                                   (8, 4)])
def test_fold_leaves_each_sum_where_the_owner_reads_it(tr, tk):
    """After the fold, sum i of lane ``lane`` is tile entry
    ``i + CF * (lane // S)`` (CF = max(1, C0 / 32), S = max(1, 32 / C0)),
    summed over the 32 lanes: the index the owner lanes (lane % S == 0)
    update and publish."""
    c0 = tr * tk
    rng = np.random.default_rng(c0)
    vals = rng.normal(size=(32, c0)) + 1j * rng.normal(size=(32, c0))
    out = _fold(vals)
    cf = max(1, c0 // 32)
    step = max(1, 32 // c0)
    total = vals.sum(axis=0)
    owners = set()
    for lane in range(32):
        assert len(out[lane]) == cf
        for i in range(cf):
            idx = i + cf * (lane // step)
            assert abs(out[lane][i] - total[idx]) < 1e-12
            if lane % step == 0:
                owners.add(idx)
    assert owners == set(range(c0))  # every entry has exactly one owner


def test_ring_kernel_source_is_part_of_the_build():
    """The build takes every ``.cu`` under ``csrc``: the ring kernel's
    source is among them with its entry point, and its phase-clock build
    beside the two cluster kernels'.  Its flag stride comes from the
    exchange header it shares with the grid state scan."""
    import os

    from grape_tpu_torch.ops import _build

    cu, hdr = _build.kernel_sources()
    names = [os.path.basename(f) for f in cu]
    assert "cheby_ring.cu" in names and "cheby_scan.cu" in names
    with open(cu[names.index("cheby_ring.cu")]) as f:
        src = f.read()
    headers = {os.path.basename(f): f for f in hdr}
    with open(headers["flag_ring.cuh"]) as f:
        exchange = f.read()
    assert "int grape_cheby_ring(" in src
    assert "GRAPE_CLOCK_READER(grape_cheby_ring_clock" in src
    assert '#include "flag_ring.cuh"' in src
    assert "kFlagStride = 32" in exchange and "kComputeWarps = 8" in src
    assert "cheby_ring.cu" in _build._CLOCKED
