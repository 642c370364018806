"""Forward scan and co-state chain: CUDA kernels, their wrappers and their
plain PyTorch versions.

Counterpart of ``grape_tpu/ops/pallas_prop.py`` for the kernels of the
gate-optimization, the robust-ensemble and the small-dimension ensemble
paths.  The trajectories come in
``G`` groups of ``gs`` contiguous ones that share a generator
(``K = G·gs``); one pair of device kernels (``csrc/prop_scan.cu``) serves
every grouping:

- :func:`forward_scan_shared` replaces ``forward_scan_pallas_shared``
  (``G = 1``), :func:`forward_scan_grouped` replaces
  ``forward_scan_pallas_grouped`` (``gs > 1``) and
  :func:`forward_scan_pertraj` replaces ``forward_scan_pallas``
  (``gs = 1``): per step and group ``H_ng = H0_g + Σ_t c[n,t]·Op_gt``,
  ``U_ng = [Taylor-PS degree 16 of (−i·dt_n·H_ng·2^−s)]^(2^s)``,
  ``ψ ← ψ·U_ngᵀ`` for the group's ``(gs, d)`` state block.  One wrapper,
  two device launches: a batched propagator kernel over the independent
  (step, group) items, then a sequential apply-scan.  The coefficient table
  may be one ``(N_T, T)`` for all groups or ``(G, N_T, T)``, one per group.
  The propagators come from one of two kernels (:func:`propagator_route`):
  the cluster kernel of ``csrc/prop_cluster.cu`` where an exponential's
  working set fits the shared memory of four CTAs (``d ≤ 108``), else the
  batched Karatsuba products of ``csrc/prop_wide.cu``, every stage of the
  polynomial one product over (item, output tile) (:func:`wide_plan`).  The
  state chains of both directions come from the cluster scan of
  ``csrc/state_scan.cu`` (:func:`scan_route`), or, where not even its
  two-stage ring fits, from the co-resident grid of ``csrc/state_grid.cu``,
  which reads the co-state's columns of ``U`` in place.  The kernels these
  replaced, the global-scratch propagator kernel and the one-block scans of
  ``csrc/prop_scan.cu`` (past ``d = 807`` the χ chain as the one-block
  forward scan over ``U†`` reversed, :func:`_chi_by_apply`), run only
  where :func:`_forced_routes` asks for them, for comparisons.
- :func:`chi_scan_shared` replaces ``chi_scan_pallas_shared``, and
  :func:`chi_scan_grouped` is the same chain over grouped or per-trajectory
  stored propagators (a scan of small products in the reference): in
  reverse time emit ``chis[n] = χ(t_{n+1})``, then ``χ ← χ·conj(U_ng)``.
- :func:`chi_scan_recompute` is the chain without stored propagators: the
  propagator kernel recomputes them one window of steps at a time.
- :func:`forward_scan_smalld` replaces ``forward_scan_pallas_smalld``: the
  forward scan of a large ensemble (one generator per trajectory) of tiny
  systems, ``d ≤ 4``, with the matrices in registers, one thread per
  (step, trajectory) exponential: one fused launch
  (``csrc/smalld_fused.cu``, :func:`smalld_route`) whose CTAs form the
  propagators of a tile of trajectories window by window in shared memory
  while their chain warp walks the previous window; the two-launch pair of
  ``csrc/smalld_scan.cu`` stays for comparison only (forced).
- :func:`forward_scan_time` replaces ``forward_scan_pallas_time``: the
  per-trajectory forward scan without the propagator stream.  Its TPU
  layout (a sequential grid over the steps with the K trajectories
  unrolled in each step, for small K) has no meaning on the card, where
  the (step, trajectory) exponentials are independent: it runs the same
  kernel pair as :func:`forward_scan_pertraj`, or the fused small-dimension
  kernel under its gates.
- :func:`taylor_order_for_bound` is the host helper that sizes the static
  order count of the time-vectorized Taylor backward pass.

Each wrapper launches its kernels for a CUDA tensor (or raises) and runs the
plain version only for a CPU tensor; ``launches`` counts, per wrapper, the
calls that launched, and ``route_launches`` the launches of each route of
the propagator kernel and of the state scans.  The kernels take complex64
only (full float32 FMAs).
"""

import contextlib

import torch

from . import plain_forced
from ._build import check, load_kernels
from .expm import expm_taylor_ps

__all__ = [
    "forward_scan_shared", "forward_scan_shared_plain",
    "forward_scan_grouped", "forward_scan_grouped_plain",
    "forward_scan_pertraj", "forward_scan_pertraj_plain",
    "chi_scan_shared", "chi_scan_shared_plain",
    "chi_scan_grouped", "chi_scan_grouped_plain",
    "chi_scan_recompute", "chi_scan_recompute_plain", "chi_window_plain",
    "forward_scan_smalld", "forward_scan_smalld_plain",
    "forward_scan_time", "forward_scan_time_plain",
    "taylor_order_for_bound",
    "propagators", "propagators_shared", "propagator_route", "wide_plan",
    "scan_route", "grid_plan", "smalld_route", "launches", "route_launches",
]

# wrapper calls that launched their kernels
launches = {
    "forward_scan_shared": 0, "chi_scan_shared": 0,
    "forward_scan_grouped": 0, "forward_scan_pertraj": 0,
    "chi_scan_grouped": 0, "chi_scan_recompute": 0,
    "forward_scan_smalld": 0, "forward_scan_time": 0,
}

# kernel launches per route: the propagator kernels (cluster, wide, and the
# global-scratch one only forced) and the state scans (cluster or grid per
# direction, and the one-block ones only forced)
route_launches = {
    "propagators_cluster": 0, "propagators_wide": 0, "propagators_global": 0,
    "state_scan_forward": 0, "state_scan_chi": 0,
    "state_scan_grid_forward": 0, "state_scan_grid_chi": 0,
    "state_scan_legacy_forward": 0, "state_scan_legacy_chi": 0,
    "state_scan_legacy_chi_by_apply": 0,
    "smalld_fused": 0, "smalld_pair": 0,
}

# the one-block χ scan's blocks: 4 trajectories, 8 row groups of partial
# sums (csrc/prop_scan.cu kKB, kRowGroups)
_LEGACY_KB, _LEGACY_ROW_GROUPS = 4, 8

# shared memory one block may use on sm_90, in bytes
_SMEM_MAX = 232448

# CTAs of the propagator kernel's cluster and the output tiles one of its
# blocks holds (csrc/prop_cluster.cu kCtas, kTileSlots)
PROP_CLUSTER_CTAS = 4
PROP_CLUSTER_TILES = 192

# the state scans' largest cluster and deepest ring (csrc/state_scan.cu)
SCAN_MAX_CLUSTER = 16
SCAN_MAX_STAGES = 8

# the wide propagator kernel (csrc/prop_wide.cu): the output tile of each
# configuration, matrices and planes per item in flight, the scratch budget
# of the items in flight (a fixed byte count of this card's 80 GB: at
# d = 1024 a window of 24 items, 4608 CTAs a stage) and the largest window
# (the grid's y extent)
WIDE_TILES = (128, 64)
WIDE_MATS, WIDE_PLANES = 7, 3
_WIDE_SCRATCH_BYTES = 2 * 1024**3
WIDE_MAX_WINDOW = 65535

# the grid state scan (csrc/state_grid.cu): entries of a piece, reduction
# indices of a piece, float2 per row of a co-state piece, the deepest ring,
# the mbarrier head and the two fold buffers (float2), the compute threads
# (each acquires one owner's flag), the stride of the flags (one 128-byte
# line each)
GRID_GROUP, GRID_PIECE, GRID_CHI_PITCH = 8, 256, 10
GRID_MAX_STAGES, GRID_HEAD, GRID_RED = 16, 512, 2 * 8 * 32
GRID_COMPUTE_THREADS = 256
GRID_FLAG_STRIDE = 32

# routes forced for checks and timings (see _forced_routes)
_forced = {"propagators": None, "scan": None}
# the small-dimension route forced for checks and timings (see
# _forced_smalld_route)
_forced_smalld = {"route": None}

# largest dimension the small-dimension kernel holds in registers
SMALLD_MAX_DIM = 4

# trajectories from which forward_scan_time takes the small-dimension
# kernel (the gate of the small-dimension route of fg)
SMALLD_MIN_TRAJ = 128

# the fused small-dimension kernel (csrc/smalld_fused.cu): most
# trajectories per CTA, propagator items per window (one per producer
# thread), most steps per window
SMALLD_MAX_TILE = 32
SMALLD_WINDOW_ITEMS = 256
SMALLD_MAX_WINDOW = 64

# blocks of the persistent propagator grid per multiprocessor
_BLOCKS_PER_SM = 2

# (step, group) items per batched product of the plain propagators, so the
# (chunk, G, d, d) intermediates stay bounded
_PLAIN_CHUNK = 250

# bytes of propagators held at a time where the stream is not kept
_WINDOW_BYTES = 1024**3


def _require(cond, msg):
    if not cond:
        raise ValueError(msg)


def _check_tensor(name, x, dtype, shape, device):
    _require(x.device == device, f"{name} is on {x.device}, not {device}")
    _require(x.dtype == dtype, f"{name} must be {dtype}, got {x.dtype}")
    _require(
        tuple(x.shape) == tuple(shape),
        f"{name} must have shape {tuple(shape)}, got {tuple(x.shape)}",
    )
    _require(x.is_contiguous(), f"{name} must be contiguous")


def _grid_blocks(device, n_items):
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(int(n_items), _BLOCKS_PER_SM * sms))


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _squarings(n_squarings):
    s = int(n_squarings)
    _require(0 <= s <= 32, f"n_squarings out of range: {s}")
    return s


def _check_group_args(H0, ops, coeffs, dts):
    """Validate grouped generator inputs ``H0 (G, d, d)``,
    ``ops (G, T, d, d)``, ``coeffs (N_T, T)`` or ``(G, N_T, T)``,
    ``dts (N_T,)``; returns ``(G, T, d, N_T, coeff_group_stride)`` with the
    stride in floats between two groups' tables (0 for a shared table)."""
    device = H0.device
    _require(H0.ndim == 3 and ops.ndim == 4,
             "H0 must be (G, d, d) and ops (G, T, d, d)")
    G, d = H0.shape[0], H0.shape[-1]
    T = ops.shape[1]
    N_T = dts.shape[0]
    _check_tensor("H0", H0, torch.complex64, (G, d, d), device)
    _check_tensor("ops", ops, torch.complex64, (G, T, d, d), device)
    per_group = coeffs.ndim == 3
    _check_tensor("coeffs", coeffs, torch.float32,
                  (G, N_T, T) if per_group else (N_T, T), device)
    _check_tensor("dts", dts, torch.float32, (N_T,), device)
    _require(N_T >= 1 and G >= 1, "need at least one time step and group")
    return G, T, d, N_T, (N_T * T if per_group else 0)


def _check_generator_args(H0, ops, coeffs, dts):
    """Validate the inputs of a SHARED generator (``H0 (d, d)``,
    ``ops (T, d, d)``, ``coeffs (N_T, T)``); returns ``(T, d, N_T)``."""
    _require(H0.ndim == 2 and ops.ndim == 3 and coeffs.ndim == 2,
             "H0 must be (d, d), ops (T, d, d) and coeffs (N_T, T)")
    _, T, d, N_T, _ = _check_group_args(H0[None], ops[None], coeffs, dts)
    return T, d, N_T


def _group_size(K, G):
    _require(G >= 1 and K % G == 0,
             f"{K} trajectories do not split into {G} groups")
    return K // G


# --------------------------------------------------------------------------
# Routes
# --------------------------------------------------------------------------

def _ceil_div(a, b):
    return -(-int(a) // int(b))


def _prop_cluster_smem(d):
    """Shared-memory bytes of one CTA of the cluster propagator kernel: 128
    bytes for its mbarrier, the right operand (two planes of depth ×
    ⌈d/4⌉·4, the depth d padded to even), four row slabs (two planes of
    depth × the slab's rows padded to 4) and a row-major export buffer
    (two planes of padded rows × ⌈d/4⌉·4); the formula of
    ``csrc/prop_cluster.cu`` ``smem_bytes``."""
    rows = _ceil_div(d, PROP_CLUSTER_CTAS)
    pitch = 4 * _ceil_div(rows, 4)
    width = 4 * _ceil_div(d, 4)
    depth = 2 * _ceil_div(d, 2)
    return 128 + 4 * (2 * depth * width + 8 * depth * pitch
                      + 2 * pitch * width)


def _prop_cluster_tiles(d):
    """4 × 4 output tiles of one CTA's row slab (at most 192: one per pair
    of threads of the 384-thread block)."""
    rows = _ceil_div(d, PROP_CLUSTER_CTAS)
    return _ceil_div(rows, 4) * _ceil_div(d, 4)


def propagator_route(d):
    """The propagator kernel for dimension ``d``: ``"cluster"`` (the
    working set of an exponential in the shared memory of a cluster of
    four CTAs, ``csrc/prop_cluster.cu``) where it fits, d ≤ 108, else
    ``"wide"`` (batched Karatsuba products over (item, output tile),
    ``csrc/prop_wide.cu``).  The same rule on the CPU and on the card; the
    global-scratch kernel of ``csrc/prop_scan.cu`` runs only forced."""
    d = int(d)
    fits = (d >= 1 and _prop_cluster_smem(d) <= _SMEM_MAX
            and _prop_cluster_tiles(d) <= PROP_CLUSTER_TILES)
    return "cluster" if fits else "wide"


def wide_plan(d, n_items):
    """The launch plan of the wide propagator kernel for ``n_items``
    exponentials of dimension ``d``: ``{"config", "tile", "pitch",
    "tiles", "item_floats", "window", "windows", "scratch_bytes"}``.

    Rows are padded to ``pitch`` (a multiple of 4 floats); the square
    output tile is the one of ``WIDE_TILES`` that covers the fewest padded
    entries (the larger on a tie); ``tiles`` per item and product, each
    formed plane by plane by three CTAs.  An item in flight holds seven
    matrices of three planes and a counter per tile (``item_floats``); a
    window holds at most as many items as ``_WIDE_SCRATCH_BYTES`` allows
    (at least one, at most ``WIDE_MAX_WINDOW``), the items split evenly
    over the fewest windows, and every stage is one launch per window (``csrc/prop_wide.cu`` ``grape_propagators_wide_scratch_floats``)."""
    d, n_items = int(d), int(n_items)
    pitch = 4 * _ceil_div(d, 4)
    best = None
    for config, t in enumerate(WIDE_TILES):
        tiles = _ceil_div(d, t) * _ceil_div(pitch, t)
        if best is None or tiles * t * t < best[0]:
            best = (tiles * t * t, config, tiles)
    _, config, tiles = best
    item_floats = WIDE_MATS * WIDE_PLANES * d * pitch + tiles
    most = max(1, min(n_items, WIDE_MAX_WINDOW,
                      _WIDE_SCRATCH_BYTES // (4 * item_floats)))
    windows = _ceil_div(n_items, most)
    # windows of even size: no short last window leaves the card idle
    window = _ceil_div(n_items, windows)
    return {"config": config, "tile": WIDE_TILES[config], "pitch": pitch,
            "tiles": tiles, "item_floats": item_floats, "window": window,
            "windows": windows,
            "scratch_bytes": 4 * item_floats * window}


def _scan_slot(d, cluster):
    """``float2`` per ring slot of the cluster scan: ``d`` rows of the
    widest CTA's entries (pairs of entries where ``d`` is even) at a pitch
    ≡ 2 mod 4, rounded up to 128 bytes (``csrc/state_scan.cu``
    ``slot_elems``)."""
    if d % 2 == 0:
        n = 2 * _ceil_div(d // 2, cluster)
    else:
        n = _ceil_div(d, cluster)
    pitch = n + (2 - n % 4) % 4
    return 16 * _ceil_div(d * pitch, 16)


def _scan_smem(d, kb, cluster, stages):
    """Shared-memory bytes of one CTA of the cluster scan: 256 bytes of
    mbarriers, three state buffers of ``kb`` states (rounded up to 128
    bytes) and ``stages`` slots (``csrc/state_scan.cu`` ``smem_bytes``)."""
    states = 16 * _ceil_div(3 * kb * d, 16)
    return 256 + 8 * (states + stages * _scan_slot(d, cluster))


def _scan_stages(d, kb, cluster):
    free = _SMEM_MAX - _scan_smem(d, kb, cluster, 0)
    return min(SCAN_MAX_STAGES, free // (8 * _scan_slot(d, cluster)))


def _grid_stage(d):
    """``float2`` per ring stage of the grid scan: a co-state piece (the
    larger of the two directions' pieces: ``min(d, 256)`` rows of 10),
    rounded up to 128 bytes (``csrc/state_grid.cu`` ``stage_elems``)."""
    return 16 * _ceil_div(min(int(d), GRID_PIECE) * GRID_CHI_PITCH, 16)


def _grid_smem(d, kb, stages):
    """Shared-memory bytes of one CTA of the grid scan: the mbarriers, the
    state ``[d][kb]`` (rounded up to 128 bytes), the fold buffers and
    ``stages`` ring stages (``csrc/state_grid.cu`` ``smem_bytes``)."""
    state = 16 * _ceil_div(int(d) * int(kb), 16)
    return GRID_HEAD + 8 * (state + GRID_RED + stages * _grid_stage(d))


def grid_plan(d, kb, chunks, sm_count):
    """The grid scan's launch plan: ``teams`` of ``ctas`` CTAs (one per SM,
    at most one team per chunk, the chunks dealt to the teams in rounds),
    CTA ``r`` of a team owning the ``entries`` output entries from
    ``r · entries`` (``used`` CTAs own one or more, ``groups`` pieces of 8
    per reduction index range), and the ring as deep as shared memory
    allows (``stages``, at most 16; fewer than 2: the plan does not fit).
    Where ``d`` is even the entries come in pairs, so that every box of
    columns starts on 16 bytes, as TMA requires."""
    d, kb, chunks, sms = int(d), int(kb), int(chunks), int(sm_count)
    teams = max(1, min(chunks, sms))
    ctas = max(1, min(sms // teams, GRID_COMPUTE_THREADS))
    entries = _ceil_div(d, ctas)
    if d % 2 == 0:
        # pairs: a co-state piece's box then starts 16-byte aligned (TMA)
        entries += entries % 2
    stages = min(GRID_MAX_STAGES, (_SMEM_MAX - _grid_smem(d, kb, 0))
                 // (8 * _grid_stage(d)))
    return {"route": "grid", "kb": kb, "chunks": chunks, "cluster": None,
            "stages": max(0, stages), "teams": teams, "ctas": ctas,
            "entries": entries, "used": _ceil_div(d, entries),
            "groups": _ceil_div(entries, GRID_GROUP),
            "smem": _grid_smem(d, kb, max(0, stages))}


def scan_route(d, G, gs, sm_count, cluster=None):
    """The launch plan of the state scans (both directions) for ``G``
    groups of ``gs`` trajectories at dimension ``d`` on a card of
    ``sm_count`` SMs: ``{"route", "kb", "chunks", "cluster", "stages"}``.

    A chunk carries ``kb`` = 1, 2 or 4 states of one group (1 at ``gs`` = 1,
    2 at ``gs`` = 2, else 4); the cluster size is the largest of 16, 8, 4,
    2 whose clusters for all chunks take at most half the SMs
    (``cluster · chunks ≤ sm_count / 2``: clusters are placed within one
    GPC each, so at 132 SMs only 30 of 4 CTAs fit at once, not 33) and
    give every CTA an output entry, else 1; grown while a ring of two slabs
    of U does not fit; the ring as deep as shared memory allows, up to 8.
    Where not even 16 CTAs fit, the co-resident grid of
    ``csrc/state_grid.cu`` (:func:`grid_plan`), and ``"legacy"`` only where
    its state and a ring of two pieces do not fit one CTA either (d past
    about 5800 at ``kb`` = 4).  ``cluster`` forces a size, ``"grid"`` the
    grid (checks and timings)."""
    d, G, gs = int(d), int(G), int(gs)
    kb = 1 if gs == 1 else 2 if gs == 2 else 4
    chunks = G * _ceil_div(gs, kb)
    if cluster == "grid":
        return grid_plan(d, kb, chunks, sm_count)
    if cluster is None:
        cluster = 1
        for c in (16, 8, 4, 2):
            if c <= d and 2 * c * chunks <= int(sm_count):
                cluster = c
                break
        while (_scan_stages(d, kb, cluster) < 2 and cluster < SCAN_MAX_CLUSTER
               and 2 * cluster <= d):
            cluster *= 2
    cluster = int(cluster)
    stages = _scan_stages(d, kb, cluster)
    if 1 <= cluster <= min(SCAN_MAX_CLUSTER, d) and stages >= 2:
        return {"route": "cluster", "kb": kb, "chunks": chunks,
                "cluster": cluster, "stages": stages}
    grid = grid_plan(d, kb, chunks, sm_count)
    if grid["stages"] >= 2:
        return grid
    return {"route": "legacy", "kb": kb, "chunks": chunks,
            "cluster": cluster, "stages": stages}


def smalld_route(d, K, N_T, sm_count):
    """The launch plan of the small-dimension forward scan for ``K``
    trajectories of dimension ``d ≤ 4`` over ``N_T`` steps on a card of
    ``sm_count`` SMs: ``{"route", "tile", "window", "ctas", "smem"}``.

    The fused kernel (``csrc/smalld_fused.cu``) takes every shape: one CTA
    per tile of trajectories, the tile the smallest power of two up to 32
    whose CTAs fit one wave (8 at K = 1024 on 132 SMs: 128 CTAs); windows
    of ``window`` steps, one propagator item per producer thread (``window
    · tile ≤ 256``, at most 64 steps, at most ``N_T``); two shared buffers
    of ``window · tile`` propagators at an odd pitch of ``d² | 1``
    ``float2``.  The two-launch pair (``"pair"``, ``csrc/smalld_scan.cu``)
    is taken only where a check forces it."""
    d, K, N_T = int(d), int(K), int(N_T)
    tile = 1
    while tile < SMALLD_MAX_TILE and _ceil_div(K, tile) > int(sm_count):
        tile *= 2
    window = min(N_T, SMALLD_MAX_WINDOW, SMALLD_WINDOW_ITEMS // tile)
    smem = 2 * window * tile * ((d * d) | 1) * 8
    return {"route": "fused", "tile": tile, "window": window,
            "ctas": _ceil_div(K, tile), "smem": smem}


@contextlib.contextmanager
def _forced_smalld_route(route):
    """Within the block the small-dimension scan takes ``route``,
    ``"fused"`` or ``"pair"`` (checks and timings of ``chip_smoke.py``;
    nothing in the package uses it)."""
    old = _forced_smalld["route"]
    _forced_smalld["route"] = route
    try:
        yield
    finally:
        _forced_smalld["route"] = old


@contextlib.contextmanager
def _forced_routes(propagators=None, scan=None):
    """Within the block the wrappers take the forced routes: ``propagators``
    ``"cluster"``, ``"wide"`` or ``"global"``, ``scan`` ``"legacy"``,
    ``"grid"`` or a cluster size (checks and timings of ``chip_smoke.py``;
    nothing in the package uses it)."""
    old = dict(_forced)
    _forced.update(propagators=propagators, scan=scan)
    try:
        yield
    finally:
        _forced.update(old)


def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


# --------------------------------------------------------------------------
# Propagators
# --------------------------------------------------------------------------

def propagators(H0, ops, coeffs, dts, n_squarings):
    """``U (N_T, G, d, d)`` by the batched propagator kernel (CUDA tensors
    only; the first of the two launches of the forward scans), on the route
    of :func:`propagator_route`.  Arguments as :func:`_check_group_args`."""
    G, T, d, N_T, stride = _check_group_args(H0, ops, coeffs, dts)
    device = H0.device
    _require(device.type == "cuda", "propagators needs CUDA tensors")
    s = _squarings(n_squarings)
    lib = load_kernels()
    route = _forced["propagators"] or propagator_route(d)
    U = torch.empty((N_T, G, d, d), dtype=torch.complex64, device=device)
    with torch.cuda.device(device):
        if route == "cluster":
            check(lib, lib.grape_propagators_cluster(
                H0.data_ptr(), ops.data_ptr(), coeffs.data_ptr(),
                dts.data_ptr(), T, d, N_T, G, stride, s, U.data_ptr(),
                _stream(device),
            ), "cluster propagator kernel launch")
        elif route == "wide":
            plan = wide_plan(d, N_T * G)
            _require(lib.grape_propagators_wide_scratch_floats(
                d, plan["window"], plan["config"])
                == plan["window"] * plan["item_floats"],
                "the wide propagator kernel's scratch layout differs")
            scratch = torch.empty(plan["window"] * plan["item_floats"],
                                  dtype=torch.float32, device=device)
            check(lib, lib.grape_propagators_wide(
                H0.data_ptr(), ops.data_ptr(), coeffs.data_ptr(),
                dts.data_ptr(), T, d, N_T, G, stride, s, scratch.data_ptr(),
                plan["window"], plan["config"], U.data_ptr(), _stream(device),
            ), "wide propagator kernel launch")
        else:
            _require(route == "global", f"unknown propagator route {route!r}")
            n_blocks = _grid_blocks(device, N_T * G)
            n_mat = lib.grape_propagator_scratch_matrices()
            scratch = torch.empty(
                (n_blocks * n_mat, d, d), dtype=torch.complex64,
                device=device
            )
            check(lib, lib.grape_propagators(
                H0.data_ptr(), ops.data_ptr(), coeffs.data_ptr(),
                dts.data_ptr(), T, d, N_T, G, stride, s, scratch.data_ptr(),
                n_blocks, U.data_ptr(), _stream(device),
            ), "propagator kernel launch")
    route_launches[f"propagators_{route}"] += 1
    return U


def propagators_shared(H0, ops, coeffs, dts, n_squarings):
    """``U (N_T, d, d)`` for a shared generator (see :func:`propagators`)."""
    _check_generator_args(H0, ops, coeffs, dts)
    U = propagators(H0[None], ops[None], coeffs, dts, n_squarings)
    return U[:, 0]


def _window(coeffs, dts, n0, n1):
    """The coefficient rows and time steps of steps ``n0..n1-1``."""
    co = coeffs[:, n0:n1] if coeffs.ndim == 3 else coeffs[n0:n1]
    return co.contiguous(), dts[n0:n1].contiguous()


def _propagators_plain(H0, ops, coeffs, dts, n_squarings):
    """Plain ``U (N_T, G, d, d)`` for grouped inputs of any complex type."""
    cdtype = H0.dtype
    G, d = H0.shape[0], H0.shape[-1]
    N_T = dts.shape[0]
    s = int(n_squarings)
    scale = 2.0 ** (-s)
    U = torch.empty((N_T, G, d, d), dtype=cdtype, device=H0.device)
    chunk = max(1, _PLAIN_CHUNK // G)
    for c0 in range(0, N_T, chunk):
        co, dt = _window(coeffs, dts, c0, c0 + chunk)
        co = co.to(cdtype)
        if co.ndim == 3:
            H = H0[None] + torch.einsum("gnt,gtij->ngij", co, ops)
        else:
            H = H0[None] + torch.einsum("nt,gtij->ngij", co, ops)
        # A = -i dt H 2^-s  (Ar = dt Hi, Ai = -dt Hr)
        A = (-1j * dt.to(cdtype) * scale)[:, None, None, None] * H
        E = expm_taylor_ps(A)
        for _ in range(s):
            E = E @ E
        U[c0:c0 + chunk] = E
    return U


def _window_steps(G, d, N_T):
    """Time steps per window of at most ``_WINDOW_BYTES`` of propagators."""
    return max(1, min(N_T, _WINDOW_BYTES // (G * d * d * 8)))


# --------------------------------------------------------------------------
# Forward scans
# --------------------------------------------------------------------------

def _forward_scan_plain(H0, ops, coeffs, dts, psi0, n_squarings,
                        with_propagators=True):
    """Plain forward scan for grouped inputs: ``(storage (N_T+1, K, d),
    U (N_T, G, d, d) or None)``."""
    G = H0.shape[0]
    K, d = psi0.shape
    gs = _group_size(K, G)
    N_T = dts.shape[0]
    storage = torch.empty((N_T + 1, K, d), dtype=psi0.dtype,
                          device=psi0.device)
    U = None
    if with_propagators:
        U = torch.empty((N_T, G, d, d), dtype=psi0.dtype, device=psi0.device)
    psi = psi0.reshape(G, gs, d)
    storage[0] = psi0
    C = _window_steps(G, d, N_T)
    for n0 in range(0, N_T, C):
        co, dt = _window(coeffs, dts, n0, n0 + C)
        Uw = _propagators_plain(H0, ops, co, dt, n_squarings)
        if U is not None:
            U[n0:n0 + C] = Uw
        for j in range(Uw.shape[0]):
            # row vectors: ψ_new = ψ·Uᵀ, per group
            psi = psi @ Uw[j].transpose(-1, -2)
            storage[n0 + j + 1] = psi.reshape(K, d)
    return storage, U


def _forward_scan(name, H0, ops, coeffs, dts, psi0, n_squarings,
                  with_propagators):
    """The forward scan of wrapper ``name`` on grouped inputs: the plain
    version for CPU tensors, else the propagator kernel and the apply-scan,
    over the whole time grid when the propagators are kept and window by
    window when they are not."""
    if psi0.device.type == "cpu" or plain_forced():
        return _forward_scan_plain(H0, ops, coeffs, dts, psi0, n_squarings,
                                   with_propagators)
    G, _, d, N_T, _ = _check_group_args(H0, ops, coeffs, dts)
    device = H0.device
    K = psi0.shape[0]
    _group_size(K, G)
    _check_tensor("psi0", psi0, torch.complex64, (K, d), device)
    lib = load_kernels()
    storage = torch.empty((N_T + 1, K, d), dtype=torch.complex64,
                          device=device)
    C = N_T if with_propagators else _window_steps(G, d, N_T)
    U = None
    psi_in = psi0
    for n0 in range(0, N_T, C):
        co, dt = _window(coeffs, dts, n0, n0 + C)
        U = propagators(H0, ops, co, dt, n_squarings)
        _state_scan(lib, U, psi_in, storage[n0:], None, chi=False)
        if n0 + C < N_T:
            # the next window starts from a copy of this one's last state
            # (the kernel writes its start state back to that row)
            psi_in = storage[n0 + C].clone()
    launches[name] += 1
    return storage, (U if with_propagators else None)


def forward_scan_shared_plain(H0, ops, coeffs, dts, psi0, n_squarings):
    """Plain PyTorch version of :func:`forward_scan_shared` (same Taylor
    degree, same static ``s``, same squarings)."""
    storage, U = _forward_scan_plain(
        H0[None], ops[None], coeffs, dts, psi0, n_squarings
    )
    return storage, U[:, 0]


def forward_scan_shared(H0, ops, coeffs, dts, psi0, n_squarings):
    """Forward propagation for a SHARED generator with the propagator
    stream.

    Args:
      H0:   (d, d) complex64 drift
      ops:  (T, d, d) complex64 control-term operators
      coeffs: (N_T, T) float32 per-step term coefficients
      dts:  (N_T,) float32 time steps
      psi0: (K, d) complex64 initial states
      n_squarings: squaring count ``s`` (a runtime integer here: a new value
        rebuilds nothing)

    Returns ``(storage (N_T+1, K, d), U (N_T, d, d))`` complex64, with
    ``storage[0] = psi0``.
    """
    _require(H0.ndim == 2 and ops.ndim == 3 and coeffs.ndim == 2,
             "H0 must be (d, d), ops (T, d, d) and coeffs (N_T, T)")
    storage, U = _forward_scan(
        "forward_scan_shared", H0[None], ops[None], coeffs, dts, psi0,
        n_squarings, True,
    )
    return storage, U[:, 0]


def forward_scan_grouped_plain(H0, ops, coeffs, dts, psi0, group_size,
                               n_squarings, with_propagators=True):
    """Plain PyTorch version of :func:`forward_scan_grouped`."""
    _require(H0.shape[0] * int(group_size) == psi0.shape[0],
             "psi0 must hold group_size trajectories per group")
    return _forward_scan_plain(H0, ops, coeffs, dts, psi0, n_squarings,
                               with_propagators)


def forward_scan_grouped(H0, ops, coeffs, dts, psi0, group_size,
                         n_squarings, with_propagators=True):
    """Forward propagation for GROUPED generators (gate ensembles: each
    contiguous run of ``group_size`` trajectories shares one generator):
    one exponential per (step, group).

    Args:
      H0:   (G, d, d) complex64, one drift per group
      ops:  (G, T, d, d) complex64
      coeffs: (N_T, T) float32, or (G, N_T, T) with one table per group
      dts:  (N_T,) float32
      psi0: (K, d) complex64, ``K = G·group_size``, group-contiguous
      with_propagators: keep the propagator stream; without it the
        propagators are formed one window of steps at a time

    Returns ``(storage (N_T+1, K, d), U (N_T, G, d, d) or None)``.
    """
    _require(H0.shape[0] * int(group_size) == psi0.shape[0],
             "psi0 must hold group_size trajectories per group")
    return _forward_scan("forward_scan_grouped", H0, ops, coeffs, dts, psi0,
                         n_squarings, with_propagators)


def forward_scan_pertraj_plain(H0, ops, coeffs, dts, psi0, n_squarings,
                               with_propagators=True):
    """Plain PyTorch version of :func:`forward_scan_pertraj`."""
    _require(H0.shape[0] == psi0.shape[0], "one generator per trajectory")
    return _forward_scan_plain(H0, ops, coeffs, dts, psi0, n_squarings,
                               with_propagators)


def forward_scan_pertraj(H0, ops, coeffs, dts, psi0, n_squarings,
                         with_propagators=True):
    """Forward propagation with one generator PER TRAJECTORY (robust
    ensembles): ``H0 (K, d, d)``, ``ops (K, T, d, d)``, ``coeffs (N_T, T)``
    or ``(K, N_T, T)``; otherwise as :func:`forward_scan_grouped` with
    ``group_size = 1``.  Returns ``(storage (N_T+1, K, d),
    U (N_T, K, d, d) or None)``."""
    _require(H0.shape[0] == psi0.shape[0], "one generator per trajectory")
    return _forward_scan("forward_scan_pertraj", H0, ops, coeffs, dts, psi0,
                         n_squarings, with_propagators)


# --------------------------------------------------------------------------
# Co-state chains
# --------------------------------------------------------------------------

def chi_window_plain(Us, chi, chis, src=None):
    """The co-state chain over the window ``Us (C, G, d, d)`` into
    ``chis (C, K, d)``, with the optional sources ``src (C, K, d)`` (ξ): in
    reverse, ``chis[j] = χ`` (χ BEFORE the step-j update), then
    ``χ ← χ·conj(U_j) + src_j``.  Returns χ carried out of the window.  The
    chain is carried conjugated, ``c = χ*``, so that each step is one
    product (and sum) ``c ← c·U_j + src*_j``: one launch a step, as the
    chain is bound by launches, not arithmetic."""
    C, G = Us.shape[0], Us.shape[1]
    K, d = chi.shape
    c = chi.conj().resolve_conj().reshape(G, K // G, d)
    srcc = (None if src is None
            else src.conj().resolve_conj().reshape(C, G, K // G, d))
    seen = []
    for j in range(C - 1, -1, -1):
        seen.append(c)
        c = c @ Us[j] if srcc is None else torch.baddbmm(srcc[j], c, Us[j])
    chis.copy_(torch.stack(seen[::-1]).reshape(C, K, d).conj())
    return c.conj().resolve_conj().reshape(K, d)


def _state_scan(lib, U, x0, out, x_out, chi):
    """Launch a state scan over ``U (C, G, d, d)`` from ``x0 (K, d)``: the
    forward apply-scan into ``out`` (C+1, K, d) or, with ``chi``, the χ
    scan into ``out`` (C, K, d) and, where ``x_out`` is given, χ carried
    out of the window into it; on the route of :func:`scan_route`."""
    device = x0.device
    C, G = U.shape[0], U.shape[1]
    K, d = x0.shape
    gs = K // G
    forced = _forced["scan"]
    if forced == "legacy":
        plan = {"route": "legacy"}
    else:
        plan = scan_route(d, G, gs, _sm_count(device),
                          cluster=forced if forced in (None, "grid")
                          else int(forced))
    direction = "chi" if chi else "forward"
    with torch.cuda.device(device):
        if plan["route"] == "grid":
            kb = plan["kb"]
            ring = torch.empty((plan["teams"], 2, d, kb),
                               dtype=torch.complex64, device=device)
            flags = torch.zeros(
                plan["teams"] * plan["ctas"] * GRID_FLAG_STRIDE,
                dtype=torch.int32, device=device)
            check(lib, lib.grape_state_grid(
                U.data_ptr(), x0.data_ptr(), out.data_ptr(),
                None if x_out is None else x_out.data_ptr(), int(chi), C, K,
                d, G, gs, kb, plan["teams"], plan["ctas"], plan["entries"],
                plan["stages"], ring.data_ptr(), flags.data_ptr(),
                _stream(device),
            ), f"grid state scan ({direction}) launch")
            route_launches[f"state_scan_grid_{direction}"] += 1
        elif plan["route"] == "cluster":
            check(lib, lib.grape_state_scan(
                U.data_ptr(), x0.data_ptr(), out.data_ptr(),
                None if x_out is None else x_out.data_ptr(), int(chi), C, K,
                d, G, gs, plan["kb"], plan["cluster"], plan["stages"],
                _stream(device),
            ), f"cluster state scan ({direction}) launch")
            route_launches[f"state_scan_{direction}"] += 1
        elif chi and not legacy_chi_fits(d):
            def apply(V, x, states):
                check(lib, lib.grape_forward_apply(
                    V.data_ptr(), x.data_ptr(), states.data_ptr(), C, K, d,
                    G, gs, _stream(device),
                ), "forward apply-scan kernel launch (chi chain)")

            _chi_by_apply(apply, U, x0.contiguous(), out, x_out)
            route_launches["state_scan_legacy_chi_by_apply"] += 1
        elif chi:
            check(lib, lib.grape_chi_scan(
                U.data_ptr(), x0.data_ptr(), out.data_ptr(),
                None if x_out is None else x_out.data_ptr(), C, K, d, G, gs,
                _stream(device),
            ), "chi scan kernel launch")
            route_launches["state_scan_legacy_chi"] += 1
        else:
            check(lib, lib.grape_forward_apply(
                U.data_ptr(), x0.data_ptr(), out.data_ptr(), C, K, d, G, gs,
                _stream(device),
            ), "forward apply-scan kernel launch")
            route_launches["state_scan_legacy_forward"] += 1


def legacy_chi_fits(d):
    """True where the one-block χ scan's shared memory (the state and the
    partial sums of its row groups, ``(1 + 8)·4·d`` complex entries) fits
    one block: ``d ≤ 807``; past it the forced one-block route runs the
    chain by :func:`_chi_by_apply`."""
    smem = (1 + _LEGACY_ROW_GROUPS) * _LEGACY_KB * int(d) * 8
    return smem <= _SMEM_MAX


def _chi_by_apply(apply, U, x0, out, x_out):
    """The χ chain over ``U (C, G, d, d)`` from ``x0 (K, d)`` by a forward
    apply-scan: ``χ ← χ·conj(U_n)`` in reverse time is ``ψ ← ψ·V_jᵀ`` with
    ``V_j = U_{C-1-j}†`` forward.  ``apply(V, x0, states)`` writes the
    ``(C+1, K, d)`` states; ``out`` gets ``chis[n] = χ(t_{n+1})``, the
    states in reverse, and ``x_out`` (where given) χ carried out of the
    window.  A copy of the propagators, adjoint and reversed, is made."""
    C = U.shape[0]
    V = U.flip(0).transpose(-1, -2).conj().contiguous()
    states = torch.empty((C + 1,) + tuple(x0.shape), dtype=x0.dtype,
                         device=x0.device)
    apply(V, x0, states)
    out.copy_(states[:-1].flip(0))
    if x_out is not None:
        x_out.copy_(states[-1])


def _chi_window(lib, Us, chi, chis, carry):
    """Launch the χ scan over the window ``Us (C, G, d, d)``, writing
    ``chis (C, K, d)``; with ``carry`` returns χ carried out of the window."""
    out = torch.empty_like(chi) if carry else None
    _state_scan(lib, Us, chi, chis, out, chi=True)
    return out


def chi_scan_grouped_plain(Us, chi_hat):
    """Plain PyTorch version of :func:`chi_scan_grouped`."""
    N_T = Us.shape[0]
    K, d = chi_hat.shape
    _group_size(K, Us.shape[1])
    chis = torch.empty((N_T, K, d), dtype=chi_hat.dtype,
                       device=chi_hat.device)
    chi_window_plain(Us, chi_hat, chis)
    return chis


def _chi_scan(name, Us, chi_hat):
    if chi_hat.device.type == "cpu" or plain_forced():
        return chi_scan_grouped_plain(Us, chi_hat)
    device = chi_hat.device
    K, d = chi_hat.shape
    N_T, G = Us.shape[0], Us.shape[1]
    _group_size(K, G)
    _check_tensor("Us", Us, torch.complex64, (N_T, G, d, d), device)
    _check_tensor("chi_hat", chi_hat, torch.complex64, (K, d), device)
    _require(N_T >= 1, "need at least one time step")
    chis = torch.empty((N_T, K, d), dtype=torch.complex64, device=device)
    _chi_window(load_kernels(), Us, chi_hat, chis, carry=False)
    launches[name] += 1
    return chis


def chi_scan_shared_plain(Us, chi_hat):
    """Plain PyTorch version of :func:`chi_scan_shared`."""
    return chi_scan_grouped_plain(Us[:, None], chi_hat)


def chi_scan_shared(Us, chi_hat):
    """Backward co-state chain over stored SHARED propagators.

    ``Us (N_T, d, d)`` complex64, ``chi_hat (K, d)`` complex64.  Returns
    ``chis (N_T, K, d)`` with ``chis[n] = χ(t_{n+1})``: χ is emitted, then
    updated by ``χ ← χ·conj(U_n)`` (row-vector form of ``U_n†χ``).
    """
    _require(Us.ndim == 3, "Us must be (N_T, d, d)")
    return _chi_scan("chi_scan_shared", Us[:, None], chi_hat)


def chi_scan_grouped(Us, chi_hat):
    """Backward co-state chain over stored GROUPED or per-trajectory
    propagators: ``Us (N_T, G, d, d)`` complex64, ``chi_hat (K, d)`` with
    ``K = G·gs`` group-contiguous.  Returns ``chis (N_T, K, d)`` with
    ``chis[n] = χ(t_{n+1})``; group ``g``'s block is updated by
    ``χ ← χ·conj(U_ng)``."""
    _require(Us.ndim == 4, "Us must be (N_T, G, d, d)")
    return _chi_scan("chi_scan_grouped", Us, chi_hat)


def chi_scan_recompute_plain(H0, ops, coeffs, dts, chi_hat, n_squarings):
    """Plain PyTorch version of :func:`chi_scan_recompute`."""
    G = H0.shape[0]
    K, d = chi_hat.shape
    _group_size(K, G)
    N_T = dts.shape[0]
    chis = torch.empty((N_T, K, d), dtype=chi_hat.dtype,
                       device=chi_hat.device)
    C = _window_steps(G, d, N_T)
    chi = chi_hat
    for n1 in range(N_T, 0, -C):
        n0 = max(0, n1 - C)
        co, dt = _window(coeffs, dts, n0, n1)
        Uw = _propagators_plain(H0, ops, co, dt, n_squarings)
        chi = chi_window_plain(Uw, chi, chis[n0:n1])
    return chis, chi


def chi_scan_recompute(H0, ops, coeffs, dts, chi_hat, n_squarings):
    """Backward co-state chain WITHOUT stored propagators, for a U stream
    too large to keep: in reverse time, one window of steps at a time, the
    propagator kernel forms ``U_ng`` again and the χ-scan kernel runs the
    window and hands χ on to the next.  Generator arguments as
    :func:`forward_scan_grouped` (``K = G·gs``); returns
    ``(chis (N_T, K, d), χ(t_0))`` with ``chis[n] = χ(t_{n+1})`` and χ
    carried out of the first step (what a caller running the chain segment
    by segment hands on)."""
    if chi_hat.device.type == "cpu" or plain_forced():
        return chi_scan_recompute_plain(H0, ops, coeffs, dts, chi_hat,
                                        n_squarings)
    G, _, d, N_T, _ = _check_group_args(H0, ops, coeffs, dts)
    device = H0.device
    K = chi_hat.shape[0]
    _group_size(K, G)
    _check_tensor("chi_hat", chi_hat, torch.complex64, (K, d), device)
    lib = load_kernels()
    chis = torch.empty((N_T, K, d), dtype=torch.complex64, device=device)
    C = _window_steps(G, d, N_T)
    chi = chi_hat
    for n1 in range(N_T, 0, -C):
        n0 = max(0, n1 - C)
        co, dt = _window(coeffs, dts, n0, n1)
        Uw = propagators(H0, ops, co, dt, n_squarings)
        chi = _chi_window(lib, Uw, chi, chis[n0:n1], carry=True)
    launches["chi_scan_recompute"] += 1
    return chis, chi


# --------------------------------------------------------------------------
# Small-dimension ensembles
# --------------------------------------------------------------------------

def forward_scan_smalld_plain(H0, ops, coeffs, dts, psi0, n_squarings,
                              with_propagators=False):
    """Plain PyTorch version of :func:`forward_scan_smalld`: the same
    degree-16 Taylor polynomial at the same squaring count, batched over the
    trajectories, a Python loop over the steps."""
    _require(H0.shape[0] == psi0.shape[0], "one generator per trajectory")
    _require(coeffs.ndim == 2, "coeffs must be (N_T, T)")
    storage, U = _forward_scan_plain(H0, ops, coeffs, dts, psi0, n_squarings,
                                     with_propagators)
    return (storage, U) if with_propagators else storage


def forward_scan_smalld(H0, ops, coeffs, dts, psi0, n_squarings,
                        with_propagators=False):
    """Forward propagation of a large ensemble of SMALL systems, one
    generator per trajectory.

    Args:
      H0:   (K, d, d) complex64 drifts, ``d ≤ 4``
      ops:  (K, T, d, d) complex64 control-term operators
      coeffs: (N_T, T) float32 per-step term coefficients (one table)
      dts:  (N_T,) float32 time steps
      psi0: (K, d) complex64 initial states
      n_squarings: squaring count ``s`` (a runtime integer)
      with_propagators: also return the propagator stream; without it no
        propagator leaves the kernel

    Returns ``storage (N_T+1, K, d)`` complex64 with ``storage[0] = psi0``,
    and with ``with_propagators`` the pair ``(storage, U (N_T, K, d, d))``.
    """
    if psi0.device.type == "cpu" or plain_forced():
        return forward_scan_smalld_plain(H0, ops, coeffs, dts, psi0,
                                         n_squarings, with_propagators)
    return _smalld_scan("forward_scan_smalld", H0, ops, coeffs, dts, psi0,
                        n_squarings, with_propagators)


def _smalld_scan(name, H0, ops, coeffs, dts, psi0, n_squarings,
                 with_propagators):
    """The small-dimension kernels for wrapper ``name`` (CUDA tensors;
    arguments as :func:`forward_scan_smalld`), on the route of
    :func:`smalld_route`: one launch of the fused kernel, which writes the
    propagators only where they are kept, or the forced two-launch pair."""
    _require(coeffs.ndim == 2, "coeffs must be (N_T, T)")
    K, T, d, N_T, _ = _check_group_args(H0, ops, coeffs, dts)
    _require(1 <= d <= SMALLD_MAX_DIM,
             f"forward_scan_smalld takes d <= {SMALLD_MAX_DIM}, got {d}")
    device = H0.device
    _check_tensor("psi0", psi0, torch.complex64, (K, d), device)
    s = _squarings(n_squarings)
    lib = load_kernels()
    storage = torch.empty((N_T + 1, K, d), dtype=torch.complex64,
                          device=device)
    plan = smalld_route(d, K, N_T, _sm_count(device))
    route = _forced_smalld["route"] or plan["route"]
    if route == "fused":
        U = (torch.empty((N_T, K, d, d), dtype=torch.complex64,
                         device=device) if with_propagators else None)
        with torch.cuda.device(device):
            check(lib, lib.grape_smalld_fused(
                H0.data_ptr(), ops.data_ptr(), coeffs.data_ptr(),
                dts.data_ptr(), psi0.data_ptr(), T, d, N_T, K, s,
                plan["tile"], plan["window"], storage.data_ptr(),
                None if U is None else U.data_ptr(), _stream(device),
            ), "fused small-dimension kernel launch")
        route_launches["smalld_fused"] += 1
        launches[name] += 1
        return (storage, U) if with_propagators else storage
    _require(route == "pair", f"unknown small-dimension route {route!r}")
    C = N_T if with_propagators else _window_steps(K, d, N_T)
    U = None
    psi_in = psi0
    for n0 in range(0, N_T, C):
        co, dt = _window(coeffs, dts, n0, n0 + C)
        n_steps = dt.shape[0]
        U = torch.empty((n_steps, K, d, d), dtype=torch.complex64,
                        device=device)
        with torch.cuda.device(device):
            check(lib, lib.grape_smalld_propagators(
                H0.data_ptr(), ops.data_ptr(), co.data_ptr(), dt.data_ptr(),
                T, d, n_steps, K, s, U.data_ptr(), _stream(device),
            ), "small-dimension propagator kernel launch")
            check(lib, lib.grape_smalld_apply(
                U.data_ptr(), psi_in.data_ptr(), storage[n0:].data_ptr(),
                n_steps, K, d, _stream(device),
            ), "small-dimension apply-scan kernel launch")
        route_launches["smalld_pair"] += 1
        if n0 + C < N_T:
            # the next window starts from a copy of this one's last state
            # (the kernel writes its start state back to that row)
            psi_in = storage[n0 + C].clone()
    launches[name] += 1
    return (storage, U) if with_propagators else storage


# --------------------------------------------------------------------------
# The time-grid forward scan
# --------------------------------------------------------------------------

def _time_args(H0, ops, coeffs, psi0, degree):
    _require(int(degree) == 16,
             f"forward_scan_time takes degree=16 (the kernels' Taylor "
             f"degree), got {degree}")
    _require(H0.ndim == 3 and ops.ndim == 4 and coeffs.ndim == 2,
             "H0 must be (K, d, d), ops (K, T, d, d) and coeffs (N_T, T)")
    _require(H0.shape[0] == psi0.shape[0], "one generator per trajectory")


def forward_scan_time_plain(H0, ops, coeffs, dts, psi0, n_squarings,
                            degree=16):
    """Plain PyTorch version of :func:`forward_scan_time`."""
    _time_args(H0, ops, coeffs, psi0, degree)
    storage, _ = _forward_scan_plain(H0, ops, coeffs, dts, psi0,
                                     n_squarings, with_propagators=False)
    return storage


def forward_scan_time(H0, ops, coeffs, dts, psi0, n_squarings, degree=16):
    """Forward propagation with one generator PER TRAJECTORY and no
    propagator stream (the reference's ``forward_scan_pallas_time``).

    Args:
      H0:   (K, d, d) complex64 drifts
      ops:  (K, T, d, d) complex64 control-term operators
      coeffs: (N_T, T) float32 per-step term coefficients
      dts:  (N_T,) float32 time steps
      psi0: (K, d) complex64 initial states
      n_squarings: squaring count ``s`` (a runtime integer)
      degree: the Taylor degree, 16 (the only one the kernels take)

    Returns ``storage (N_T+1, K, d)`` complex64 with ``storage[0] = psi0``.
    On the card the exponentials of all (step, trajectory) items are formed
    in parallel and the ψ chain runs apart: the fused small-dimension
    kernel for ``d ≤ 4`` and ``K ≥ 128``, else the large-d pair of
    :func:`forward_scan_pertraj`, window by window (≤ 1 GiB of
    propagators).
    """
    if psi0.device.type == "cpu" or plain_forced():
        return forward_scan_time_plain(H0, ops, coeffs, dts, psi0,
                                       n_squarings, degree)
    _time_args(H0, ops, coeffs, psi0, degree)
    K, d = psi0.shape
    if d <= SMALLD_MAX_DIM and K >= SMALLD_MIN_TRAJ:
        return _smalld_scan("forward_scan_time", H0, ops, coeffs, dts, psi0,
                            n_squarings, with_propagators=False)
    storage, _ = _forward_scan("forward_scan_time", H0, ops, coeffs, dts,
                               psi0, n_squarings, with_propagators=False)
    return storage


def taylor_order_for_bound(bound, tolerance=1e-8, max_order=100,
                           prefactor=1.0):
    """Static Taylor order for the χ'-recursion: smallest ``m`` with
    ``prefactor · m · bound^m / m! < tolerance`` (+2 safety).  ``bound`` is
    the host-side envelope of ``|dt|·‖H‖`` (the bound that sizes the expm
    squarings); ``prefactor`` is ``‖μ‖/‖H‖``: the recursion iterates
    ``Φ_m = μ H^{m-1} χ + H Φ_{m-1}``, so ``‖Φ_m‖ ≤ m·‖μ‖·‖H‖^{m-1}`` and the
    m-th series term is bounded by ``(‖μ‖/‖H‖)·m·(dt‖H‖)^m/m!``.  Returns
    ``None`` if no order ≤ ``max_order`` satisfies the tolerance: the
    caller then takes the per-step pass with its own convergence check."""
    term = max(float(prefactor), 1e-30)
    for m in range(1, max_order + 1):
        term *= max(float(bound), 1e-30) / m
        if m * term < tolerance:
            return min(m + 2, max_order)
    return None
