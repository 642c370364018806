"""The routing rules of the propagator kernel and the state scans
(``grape_tpu_torch.ops.hopper_prop.propagator_route`` and ``scan_route``).

Both rules are pure Python, the same on the CPU and on the card, and decide
which CUDA kernel a wrapper launches: the cluster propagator kernel
(``csrc/prop_cluster.cu``) where an exponential's working set fits the
shared memory of a cluster of four CTAs, else the batched Karatsuba
products of ``csrc/prop_wide.cu`` with their tiles and windows of items
(``wide_plan``); the cluster state scan (``csrc/state_scan.cu``) with its
cluster size, states per chunk and ring depth, else the co-resident grid of
``csrc/state_grid.cu`` with its teams, slabs and ring (``grid_plan``).  The
kernels they replaced (the global-scratch propagator kernel and the
one-block scans) run only forced.  The cases cover every shape that
``chip_smoke.py`` runs the kernels at (``kernel_check``, ``kernel_shapes``,
the ensemble, time-grid, small-d, cluster and route phases) and config 3's
d = 3.  No arithmetic changes with the route, so the plain versions the CPU
runs are the same for every route."""

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
    (108, "cluster"), (109, "wide"), (112, "wide"), (128, "wide"),
    (129, "wide"), (130, "wide"), (160, "wide"), (200, "wide"),
    (1024, "wide"),
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
        assert hp.propagator_route(d) == ("cluster" if fits else "wide")
    routes = [hp.propagator_route(d) for d in range(1, 260)]
    # one crossing: every d up to 108 on the cluster, every larger d not
    assert routes == ["cluster"] * 108 + ["wide"] * (259 - 108)


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
    # past the ring: the co-resident grid (no cluster; its ring of pieces)
    ((1024, 1, 4), ("grid", 4, None, 9)),
    # scan_routes and the heterogeneous cell's ExpProp half (K = 2)
    ((1024, 1, 2), ("grid", 2, None, 10)),
    ((512, 1, 4), ("grid", 4, None, 10)),
    ((512, 1, 2), ("grid", 2, None, 10)),
    # the last d on the cluster scan at one group of 4, and the first past
    ((416, 1, 4), ("cluster", 4, 16, 2)),
    ((417, 1, 4), ("grid", 4, None, 10)),
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
        if p["route"] == "grid":
            assert hp._scan_stages(d, kb, min(16, d)) < 2
            assert hp.grid_plan(d, kb, p["chunks"], SMS) == p
            continue
        assert p["route"] == "cluster"
        c = p["cluster"]
        assert 1 <= c <= min(16, d) and 2 <= p["stages"] <= 8
        assert hp._scan_smem(d, kb, c, p["stages"]) <= SMEM_MAX
        if 2 * c * p["chunks"] > SMS and c > 1:
            # grown only because a smaller cluster's ring did not fit
            assert hp._scan_stages(d, kb, c // 2) < 2


WIDE_PLANS = [
    # (d, items): (output tile, tiles per item and product, items per
    # window, windows) -- prop_routes (128, 256, 512, 1024), the dim-144
    # CZ (144, 2000 steps), kernel_shapes (130), the first d past the
    # cluster kernel (109), the middle range (200), the largest d of the
    # plans (2048, 4096: one item a window at 4096)
    ((109, 2000), (128, 1, 2000, 1)),
    ((128, 2000), (128, 1, 1000, 2)),
    ((130, 40), (64, 9, 40, 1)),
    ((144, 2000), (64, 9, 1000, 2)),
    ((200, 2000), (128, 4, 500, 4)),
    ((256, 2000), (128, 4, 334, 6)),
    ((512, 400), (128, 16, 80, 5)),
    ((1024, 100), (128, 64, 20, 5)),
    ((2048, 100), (128, 256, 6, 17)),
    ((4096, 10), (128, 1024, 1, 10)),
]


@pytest.mark.parametrize("shape,plan", WIDE_PLANS,
                         ids=[f"d{d}-items{n}" for (d, n), _ in WIDE_PLANS])
def test_wide_plan(shape, plan):
    got = hp.wide_plan(*shape)
    assert (got["tile"], got["tiles"], got["window"], got["windows"]) == plan


def test_wide_plan_tiles_and_windows():
    """Rows padded to a multiple of 4 floats; the square tile that covers
    the fewest padded entries (the larger on a tie); seven matrices of
    three planes and a counter per tile an item; windows within the
    scratch budget (at least one item), as few as that allows, of even
    size, and enough CTAs a stage (three a tile) to fill the card four
    times over wherever there are items for it."""
    budget = hp._WIDE_SCRATCH_BYTES
    for d in list(range(109, 600)) + [700, 1000, 1024, 1500, 2048, 4096]:
        p = hp.wide_plan(d, 2000)
        assert p["pitch"] % 4 == 0 and 0 <= p["pitch"] - d < 4
        covered = [-(-d // t) * -(-p["pitch"] // t) * t * t
                   for t in hp.WIDE_TILES]
        assert p["config"] == covered.index(min(covered))
        t = p["tile"]
        assert p["tiles"] == -(-d // t) * -(-p["pitch"] // t)
        assert p["item_floats"] == 21 * d * p["pitch"] + p["tiles"]
        item_bytes = 4 * p["item_floats"]
        assert p["scratch_bytes"] == item_bytes * p["window"]
        assert p["window"] == 1 or p["scratch_bytes"] <= budget
        assert p["windows"] == -(-2000 // p["window"])
        fewest = -(-2000 // max(1, min(2000, budget // item_bytes)))
        assert p["windows"] == fewest
        assert 3 * p["window"] * p["tiles"] >= 4 * SMS
    assert hp.wide_plan(300, 1)["window"] == 1
    assert hp.wide_plan(109, 10**6)["window"] <= hp.WIDE_MAX_WINDOW


GRID_SLABS = [
    # (d, kb): (output entries a CTA owns, CTAs that own entries, pieces of
    # 8 entries, ring stages) for one chunk on 132 SMs
    ((512, 2), (4, 128, 1, 10)), ((512, 4), (4, 128, 1, 10)),
    ((1024, 1), (8, 128, 1, 10)), ((1024, 2), (8, 128, 1, 10)),
    ((1024, 4), (8, 128, 1, 9)),
    ((4096, 1), (32, 128, 4, 9)), ((4096, 2), (32, 128, 4, 7)),
    ((4096, 4), (32, 128, 4, 4)),
]


@pytest.mark.parametrize("shape,slab", GRID_SLABS,
                         ids=[f"d{d}-kb{kb}" for (d, kb), _ in GRID_SLABS])
def test_grid_plan_slab(shape, slab):
    p = hp.grid_plan(*shape, 1, SMS)
    assert (p["entries"], p["used"], p["groups"], p["stages"]) == slab
    assert p["teams"] == 1 and p["ctas"] == SMS


@pytest.mark.parametrize("kb", [1, 2, 4])
def test_grid_plan_fits_one_cta(kb):
    """For every d past the cluster scan up to 4096 and any number of
    chunks: one CTA per SM at most (the grid co-resident), at most one team
    a chunk, every CTA that is used owning an entry, the state and a ring
    of at least two pieces within one CTA's shared memory."""
    for d in list(range(417, 1401, 7)) + [2048, 3000, 4096]:
        for chunks in (1, 2, 3, 8, 33, 132, 200):
            p = hp.grid_plan(d, kb, chunks, SMS)
            assert p["smem"] == hp._grid_smem(d, kb, p["stages"])
            assert p["smem"] <= SMEM_MAX and 2 <= p["stages"] <= 16
            assert p["teams"] == min(chunks, SMS)
            assert p["teams"] * p["ctas"] <= SMS
            assert p["entries"] * p["used"] >= d
            assert (p["used"] - 1) * p["entries"] < d <= p["ctas"] * p["entries"]
            assert p["used"] <= hp.GRID_COMPUTE_THREADS
            assert p["groups"] * hp.GRID_GROUP >= p["entries"]
            # pairs where d is even: boxes of columns start on 16 bytes
            assert d % 2 or p["entries"] % 2 == 0


def test_routes_cross_over_once():
    """On d = 1..1400 the propagator rule goes from the cluster kernel to
    the wide one once, and the scan rule from the cluster scan to the grid
    once, at every layout of the paths (one group of 1, 2 or 4; 8 groups of
    4; 32 of 1)."""
    def crossings(routes):
        return sum(a != b for a, b in zip(routes, routes[1:]))

    ds = range(1, 1401)
    prop = [hp.propagator_route(d) for d in ds]
    assert prop[0] == "cluster" and prop[-1] == "wide"
    assert crossings(prop) == 1
    for G, gs in [(1, 1), (1, 2), (1, 4), (8, 4), (32, 1)]:
        scan = [hp.scan_route(d, G, gs, SMS)["route"] for d in ds]
        assert scan[0] == "cluster" and scan[-1] == "grid"
        assert crossings(scan) == 1


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


@pytest.mark.parametrize("d,G,gs,N_T", [(3, 1, 2, 7), (6, 2, 2, 7),
                                        (5, 3, 1, 7), (130, 1, 2, 3),
                                        (420, 1, 2, 2)])
def test_cpu_wrappers_launch_no_route(d, G, gs, N_T):
    """On CPU tensors the wrappers run their plain versions whatever route
    is forced, the old ones or the new (d = 130 is past the cluster
    propagator kernel, d = 420 past the cluster scan): the results equal
    the plain ones and no route counts."""
    H0, ops, co, dts, psi0 = _inputs(d, G, gs, 2, N_T, 11 * d + G)
    before = dict(hp.route_launches)
    st_p, U_p = hp.forward_scan_grouped_plain(H0, ops, co, dts, psi0, gs, 1)
    chis_p = hp.chi_scan_grouped_plain(U_p, psi0)
    for props, scan in (("global", "legacy"), ("wide", "grid")):
        with hp._forced_routes(propagators=props, scan=scan):
            st, U = hp.forward_scan_grouped(H0, ops, co, dts, psi0, gs, 1)
            chis = hp.chi_scan_grouped(U, psi0)
        assert torch.equal(st, st_p) and torch.equal(U, U_p)
        assert torch.equal(chis, chis_p)
    assert hp.route_launches == before
