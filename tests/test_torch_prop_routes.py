"""The routing rules of the propagator kernel and the state scans
(``grape_tpu_torch.ops.hopper_prop.propagator_route`` and ``scan_route``).

Both rules are pure Python, the same on the CPU and on the card, and decide
which CUDA kernel a wrapper launches: the cluster propagator kernel
(``csrc/prop_cluster.cu``) where an exponential's working set fits the
shared memory of a cluster of four CTAs, else the global-scratch one
(``csrc/prop_scan.cu``); the cluster state scan (``csrc/state_scan.cu``)
with its cluster size, states per chunk and ring depth, else the one-block
scans.  The cases cover every shape that ``chip_smoke.py`` runs the kernels
at (``kernel_check``, ``kernel_shapes``, the ensemble, time-grid, small-d
and cluster phases) and config 3's d = 3.  No arithmetic changes with the
route, so the plain versions the CPU runs are the same for every route."""

import numpy as np
import pytest
import torch

from grape_tpu_torch.ops import hopper_prop as hp

# one H100 SXM
SMS = 132
SMEM_MAX = 232448

PROP_ROUTES = [
    # (d, route): the main paths (100), config 3 and the qutrits (3), the
    # ragged shapes of chip_smoke.py, the edges of the cluster kernel
    (2, "cluster"), (3, "cluster"), (5, "cluster"), (8, "cluster"),
    (37, "cluster"), (64, "cluster"), (100, "cluster"), (104, "cluster"),
    (108, "cluster"), (109, "global"), (112, "global"), (128, "global"),
    (129, "global"), (130, "global"), (160, "global"), (200, "global"),
    (1024, "global"),
]


@pytest.mark.parametrize("d,route", PROP_ROUTES)
def test_propagator_route(d, route):
    assert hp.propagator_route(d) == route


def test_propagator_route_is_the_memory_and_tile_rule():
    """Cluster exactly where one CTA's shared memory holds the working set
    and the block holds the slab's 4 x 4 tiles; the kernel's layout at
    d = 100 is 192 KB (four slabs of 28 x 100, Y, the export)."""
    assert hp._prop_cluster_smem(100) == 128 + 4 * (
        2 * 100 * 100 + 8 * 100 * 28 + 2 * 28 * 100)
    assert hp._prop_cluster_tiles(100) == 7 * 25
    for d in range(1, 260):
        fits = (hp._prop_cluster_smem(d) <= SMEM_MAX
                and hp._prop_cluster_tiles(d) <= hp.PROP_CLUSTER_TILES)
        assert hp.propagator_route(d) == ("cluster" if fits else "global")
    routes = [hp.propagator_route(d) for d in range(1, 260)]
    # one crossing: every d up to 108 on the cluster, every larger d not
    assert routes == ["cluster"] * 108 + ["global"] * (259 - 108)


SCAN_PLANS = [
    # (d, G, gs): (route, states per chunk, cluster size, ring stages)
    # kernel_check, the CZ: one chunk on 16 CTAs
    ((100, 1, 4), ("cluster", 4, 16, 8)),
    # kernel_shapes
    ((128, 1, 8), ("cluster", 4, 16, 8)),
    ((5, 1, 1), ("cluster", 1, 4, 8)),
    ((64, 1, 9), ("cluster", 4, 16, 8)),
    ((130, 1, 2), ("cluster", 2, 16, 8)),
    ((2, 1, 1), ("cluster", 1, 2, 8)),
    # the ensembles: 8 chunks on 8 CTAs each, 32 chunks on 2
    ((100, 8, 4), ("cluster", 4, 8, 8)),
    ((100, 32, 1), ("cluster", 1, 2, 5)),
    # kernel_shapes_ensemble
    ((64, 3, 1), ("cluster", 1, 16, 8)),
    ((5, 2, 3), ("cluster", 4, 4, 8)),
    ((130, 2, 5), ("cluster", 4, 16, 8)),
    ((64, 1, 7), ("cluster", 4, 16, 8)),
    ((100, 3, 4), ("cluster", 4, 16, 8)),
    ((5, 5, 1), ("cluster", 1, 4, 8)),
    # the qutrits' co-state chain and config 3 (d = 3)
    ((3, 1024, 1), ("cluster", 1, 1, 8)),
    ((3, 1, 2), ("cluster", 2, 2, 8)),
    # kernel_check_time (one generator per trajectory)
    ((100, 4, 1), ("cluster", 1, 16, 8)),
    ((8, 3, 1), ("cluster", 1, 8, 8)),
    ((130, 3, 1), ("cluster", 1, 16, 8)),
    ((64, 1, 1), ("cluster", 1, 16, 8)),
    # kernel_shapes_cluster
    ((37, 1, 4), ("cluster", 4, 16, 8)),
    ((37, 8, 4), ("cluster", 4, 8, 8)),
    ((37, 32, 1), ("cluster", 1, 2, 8)),
    ((129, 1, 4), ("cluster", 4, 16, 8)),
    ((129, 8, 4), ("cluster", 4, 8, 8)),
    ((129, 32, 1), ("cluster", 1, 2, 3)),
    # past the ring: the one-block scans
    ((1024, 1, 4), ("legacy", 4, 16, 0)),
]


@pytest.mark.parametrize("shape,plan", SCAN_PLANS,
                         ids=[f"d{d}-G{G}-gs{gs}" for (d, G, gs), _ in
                              SCAN_PLANS])
def test_scan_route(shape, plan):
    got = hp.scan_route(*shape, SMS)
    assert (got["route"], got["kb"], got["cluster"], got["stages"]) == plan


def _plans():
    rng = np.random.default_rng(7)
    for _ in range(300):
        d = int(rng.integers(1, 1400))
        G = int(rng.integers(1, 300))
        gs = int(rng.integers(1, 9))
        yield d, G, gs


def test_scan_route_invariants():
    """States per chunk by the group size, at most half the SMs for the
    clusters unless a ring of two slabs forced a larger size, every CTA an
    entry, the plan within one CTA's shared memory."""
    for d, G, gs in _plans():
        p = hp.scan_route(d, G, gs, SMS)
        kb = 1 if gs == 1 else 2 if gs == 2 else 4
        assert p["kb"] == kb
        assert p["chunks"] == G * -(-gs // kb)
        if p["route"] == "legacy":
            assert hp._scan_stages(d, kb, min(16, d)) < 2
            continue
        c = p["cluster"]
        assert 1 <= c <= min(16, d) and 2 <= p["stages"] <= 8
        assert hp._scan_smem(d, kb, c, p["stages"]) <= SMEM_MAX
        if 2 * c * p["chunks"] > SMS and c > 1:
            # grown only because a smaller cluster's ring did not fit
            assert hp._scan_stages(d, kb, c // 2) < 2


def test_scan_slot_layout():
    """Ring slots are whole 128-byte units, and the co-state slab's pitch
    is 2 mod 4 (at most two lanes of a half-warp to a bank)."""
    for d in (2, 3, 37, 64, 100, 129, 130, 256):
        for c in (1, 2, 4, 8, 16):
            if c > d:
                continue
            slot = hp._scan_slot(d, c)
            assert slot % 16 == 0
            pitch_min = (2 * -(-(d // 2) // c) if d % 2 == 0
                         else -(-d // c))
            assert slot >= d * pitch_min


def test_forced_routes_restore():
    assert hp._forced == {"propagators": None, "scan": None}
    with hp._forced_routes(propagators="global", scan=4):
        assert hp._forced == {"propagators": "global", "scan": 4}
        with hp._forced_routes(scan="legacy"):
            assert hp._forced == {"propagators": None, "scan": "legacy"}
        assert hp._forced == {"propagators": "global", "scan": 4}
    assert hp._forced == {"propagators": None, "scan": None}


def _inputs(d, G, gs, T, N_T, seed):
    rng = np.random.default_rng(seed)

    def herm(*shape):
        A = rng.normal(size=shape) + 1j * rng.normal(size=shape)
        return (A + np.conj(np.swapaxes(A, -1, -2))) / np.sqrt(shape[-1])

    c64 = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.complex64))
    psi = rng.normal(size=(G * gs, d)) + 1j * rng.normal(size=(G * gs, d))
    psi /= np.linalg.norm(psi, axis=1, keepdims=True)
    return (c64(herm(G, d, d)), c64(herm(G, T, d, d)),
            torch.from_numpy((0.3 * rng.normal(size=(N_T, T))).astype(
                np.float32)),
            torch.from_numpy(np.full(N_T, 0.05, np.float32)), c64(psi))


@pytest.mark.parametrize("d,G,gs", [(3, 1, 2), (6, 2, 2), (5, 3, 1)])
def test_cpu_wrappers_launch_no_route(d, G, gs):
    """On CPU tensors the wrappers run their plain versions whatever route
    is forced: the results equal the plain ones and no route counts."""
    H0, ops, co, dts, psi0 = _inputs(d, G, gs, 2, 7, 11 * d + G)
    before = dict(hp.route_launches)
    st_p, U_p = hp.forward_scan_grouped_plain(H0, ops, co, dts, psi0, gs, 1)
    chis_p = hp.chi_scan_grouped_plain(U_p, psi0)
    with hp._forced_routes(propagators="global", scan="legacy"):
        st, U = hp.forward_scan_grouped(H0, ops, co, dts, psi0, gs, 1)
        chis = hp.chi_scan_grouped(U, psi0)
    assert torch.equal(st, st_p) and torch.equal(U, U_p)
    assert torch.equal(chis, chis_p)
    assert hp.route_launches == before
