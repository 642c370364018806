"""One order of the time-vectorized Taylor backward recursion: the CUDA
kernel, its wrapper and its plain PyTorch version.

The vectorized Taylor pass (``fg._backward_vectorized``) sums the series of
``χ'_{nkl} = ∂/∂ε_l exp(-i dt_n H_n)† χ`` over every step at once.  At a
large dimension and few columns it runs here, one launch an order
(``csrc/taylor_order.cu``), on the recursion with the ``Hm`` chain one order
ahead: with ``A_n = H_n†/h`` and ``μ_nl† = Σ_t dM[n, t, l] Op_t†``, order
``m`` takes ``φ_{m-1}`` and ``Hm_m = A_n^{m-1} χ`` and gives

    P_t      = Op_t† Hm_m
    Hm_{m+1} = A_n Hm_m                       (skipped at the last order)
    φ_m      = A_n φ_{m-1} + Σ_t dM[n, t, l] P_t
    acc     += coef[n] φ_m,   coef[n] = (i dt_n h)^m / m!

(the first order has no ``φ`` input: ``φ_1 = μ† χ``, ``acc = coef φ_1``).
Each entry of ``H_n†`` is formed in registers from the static operators,
read in their stored layout with the conjugate transpose taken on load, so
an order does about 1.1× the products it needs where the static-operator
einsums did 3.2× in a dozen launches.

:func:`taylor_plan` is the layout rule (the same on the CPU and on the
card); :func:`taylor_order` launches the kernel for CUDA tensors and runs
:func:`taylor_order_plain` for CPU tensors.  ``launches`` counts the
launches.  The kernel takes complex64 only (full float32 FMAs, no tensor
cores).
"""

import torch

from . import plain_forced
from ._build import check, load_kernels
from .hopper_prop import _check_tensor, _require, _stream

__all__ = ["taylor_pass", "taylor_order", "taylor_order_plain",
           "taylor_plan", "order_workspace", "TAYLOR_LAYOUTS", "launches"]

# kernel launches
launches = {"taylor_order": 0}

# the (group size, controls, terms) the kernel is built for
# (csrc/taylor_order.cu GRAPE_TAYLOR_LAYOUTS): one operator a control, one
# to four controls, groups of 1, 2 or 4.  Other layouts (terms that differ
# from the controls, other group sizes) take the static-operator einsums.
TAYLOR_LAYOUTS = {(gs, n, n) for gs in (1, 2, 4) for n in (1, 2, 3, 4)}

# threads of a CTA, contraction columns a chunk, steps and rows a CTA, rows
# a thread, shared buffers (csrc/taylor_order.cu kThreads, kBK, kSteps,
# kBM, kRows, kStages)
THREADS = 256
CHUNK = 16
STEPS = 8
ROWS = 64
THREAD_ROWS = 2
STAGES = 3
# multiprocessors of one H100 SXM: the card the rule assumes on the CPU
H100_SMS = 132
# the most ranges a tile of the last wave is split into, and the fewest
# chunks of the contraction a range keeps
MAX_PARTS = 8
MIN_PART_CHUNKS = 8


def _ceil_div(a, b):
    return -(-int(a) // int(b))


def _smem(gs, L, T):
    """Shared bytes of one CTA (csrc/taylor_order.cu ``Plan::kSmem``): each
    of the three buffers holds the ``T + 1`` operator tiles and the chunk
    of every column of 8 steps (a step's columns padded by 16 bytes)."""
    stage = (T + 1) * CHUNK * ROWS + STEPS * (gs * (L + 1) * CHUNK + 2)
    return 8 * STAGES * stage


def taylor_plan(d, N, G, gs, L, T, sm_count=H100_SMS, kparts=None):
    """The kernel's layout for one order at ``d`` rows, ``N`` steps, ``G``
    groups of ``gs`` trajectories, ``L`` controls and ``T`` terms on a card
    of ``sm_count`` SMs: ``{"tiles", "full", "kparts", "sums", "smem"}``,
    or None where the kernel is not built for ``(gs, L, T)`` or ``d`` is
    odd (its rows would not start on 16 bytes).

    A CTA owns 64 rows × 8 steps of one group (``tiles`` CTAs' worth), one
    CTA an SM; a thread keeps ``sums = 2 gs (L + 1 + T)`` complex sums in
    registers.  Where the tiles are whole waves and ``rest`` more, the
    first ``full`` tiles run whole and each of the rest is split into
    ``kparts`` ranges of the contraction (at least 8 chunks of 16 each),
    the fewest that bring the last waves closest to full.  A ``kparts``
    given takes the place of that choice (1: no tile split), for timings
    and checks of the split."""
    if (int(gs), int(L), int(T)) not in TAYLOR_LAYOUTS or int(d) % 2:
        return None
    d, N, G, sms = int(d), int(N), int(G), int(sm_count)
    _require(d >= 1 and N >= 1 and G >= 1 and sms >= 1,
             f"no Taylor-order layout for d={d}, N={N}, G={G}")
    tiles = _ceil_div(N, STEPS) * _ceil_div(d, ROWS) * G
    rest = tiles % sms
    chunks = _ceil_div(d, CHUNK)
    best, best_cost = 1, 1.0
    for kp in range(2, MAX_PARTS + 1):
        if chunks < MIN_PART_CHUNKS * kp or not rest:
            break
        # the rest's time in whole tiles: waves of 1/kp of a tile, and a
        # few per cent for the partial sums' round trip
        cost = _ceil_div(rest * kp, sms) / kp * 1.05
        if cost < best_cost - 1e-9:
            best, best_cost = kp, cost
    if kparts is not None:
        best = int(kparts)
        _require(best >= 1, f"kparts={best}")
    return {"tiles": tiles, "full": tiles - rest if best > 1 else tiles,
            "kparts": best, "sums": THREAD_ROWS * gs * (L + 1 + T),
            "smem": _smem(gs, L, T)}


def taylor_order_plain(H0, ops, coeffs, dM, coef, phi_in, hm_in, phi_out,
                       hm_out, acc, inv_h, per, first, write_hm):
    """Plain PyTorch version of :func:`taylor_order`, in the inputs'
    precision: ``H_n†`` formed per step (in chunks of steps), the products
    as einsums, the same outputs written in place."""
    G, T, d = ops.shape[0], ops.shape[1], ops.shape[-1]
    N, K = hm_in.shape[0], hm_in.shape[1]
    gs, L = K // G, dM.shape[-1]
    cdt = hm_in.dtype
    co = coeffs.to(cdt)
    dMc = dM.to(cdt)
    opc = ops.conj()
    # steps a chunk: the formed (C, G, d, d) generators within about 256 MB
    C = max(1, min(N, (256 << 20) // max(1, G * d * d * 16)))
    for c0 in range(0, N, C):
        sl = slice(c0, min(N, c0 + C))
        if per:
            Hn = H0[None] + torch.einsum("gct,gtij->cgij", co[:, sl], ops)
        else:
            Hn = H0[None] + torch.einsum("ct,gtij->cgij", co[sl], ops)
        Hc = Hn.conj()  # A = Hc^T / h
        hg = hm_in[sl].reshape(-1, G, gs, d)
        # P_t = Op_t† Hm: (Op_t†)_{ij} = conj(Op_t)_{ji}
        Pt = torch.einsum("gtji,cgsj->cgsti", opc, hg)
        if per:
            phi = torch.einsum("gctl,cgsti->cgsli", dMc[:, sl], Pt)
        else:
            phi = torch.einsum("ctl,cgsti->cgsli", dMc[sl], Pt)
        if not first:
            pg = phi_in[sl].reshape(-1, G, gs, L, d)
            phi = phi + inv_h * torch.einsum("cgji,cgslj->cgsli", Hc, pg)
        phi = phi.reshape(-1, K, L, d)
        phi_out[sl] = phi
        if write_hm:
            hm_out[sl] = (inv_h * torch.einsum(
                "cgji,cgsj->cgsi", Hc, hg)).reshape(-1, K, d)
        term = coef[sl, None, None, None] * phi
        if first:
            acc[sl] = term
        else:
            acc[sl] += term


def taylor_order(H0, ops, coeffs, dM, coef, phi_in, hm_in, phi_out, hm_out,
                 acc, inv_h, per, first, write_hm, work=None):
    """One order of the Taylor recursion, written in place.

    Args:
      H0: (G, d, d) complex64 drifts; ops: (G, T, d, d) complex64 operators
        (stored layout: the kernel takes the conjugate transpose on load)
      coeffs: (N, T) float32 real coefficients, or (G, N, T) with ``per``
      dM: (N, T, L) float32 control derivatives, or (G, N, T, L) with
        ``per`` (one table per trajectory: G = K)
      coef: (N,) complex64, ``(i dt_n h)^m / m!`` of this order
      phi_in: (N, K, L, d) complex64 ``φ_{m-1}`` (ignored when ``first``)
      hm_in: (N, K, d) complex64 ``Hm_m``
      phi_out, hm_out: outputs ``φ_m`` and ``Hm_{m+1}`` (``hm_out`` only
        when ``write_hm``); neither may alias an input
      acc: (N, K, L, d) complex64, updated (set when ``first``)
      inv_h: ``1 / h``, the recursion's scale
      work: ``(plan, workspace, counters)`` from :func:`order_workspace`,
        made here when None

    CPU tensors run :func:`taylor_order_plain`.
    """
    if hm_in.device.type == "cpu" or plain_forced():
        taylor_order_plain(H0, ops, coeffs, dM, coef, phi_in, hm_in,
                           phi_out, hm_out, acc, inv_h, per, first, write_hm)
        return
    device = hm_in.device
    G, T, d = ops.shape[0], ops.shape[1], ops.shape[-1]
    N, K = hm_in.shape[0], hm_in.shape[1]
    L = dM.shape[-1]
    _require(G >= 1 and K % G == 0, f"K={K} is not a multiple of G={G}")
    gs = K // G
    _require(not per or gs == 1,
             "per-trajectory tables need one operator entry a trajectory")
    c64, f32 = torch.complex64, torch.float32
    _check_tensor("H0", H0, c64, (G, d, d), device)
    _check_tensor("ops", ops, c64, (G, T, d, d), device)
    _check_tensor("coeffs", coeffs, f32, (G, N, T) if per else (N, T),
                  device)
    _check_tensor("dM", dM, f32, (G, N, T, L) if per else (N, T, L), device)
    _check_tensor("coef", coef, c64, (N,), device)
    if not first:
        _check_tensor("phi_in", phi_in, c64, (N, K, L, d), device)
    _check_tensor("hm_in", hm_in, c64, (N, K, d), device)
    _check_tensor("phi_out", phi_out, c64, (N, K, L, d), device)
    if write_hm:
        _check_tensor("hm_out", hm_out, c64, (N, K, d), device)
    _check_tensor("acc", acc, c64, (N, K, L, d), device)
    if work is None:
        work = order_workspace(d, N, G, gs, L, T, device)
    plan, ws, counters = work
    lib = load_kernels()
    nul = 0
    with torch.cuda.device(device):
        check(lib, lib.grape_taylor_order(
            H0.data_ptr(), ops.data_ptr(), coeffs.data_ptr(), dM.data_ptr(),
            coef.data_ptr(), nul if first else phi_in.data_ptr(),
            hm_in.data_ptr(), phi_out.data_ptr(),
            hm_out.data_ptr() if write_hm else nul, acc.data_ptr(),
            ws.data_ptr() if ws is not None else nul,
            counters.data_ptr() if counters is not None else nul,
            d, N, G, gs, L, T, int(bool(per)), int(bool(first)),
            int(bool(write_hm)), plan["full"], plan["kparts"],
            float(inv_h), _stream(device),
        ), "Taylor order kernel launch")
    launches["taylor_order"] += 1


def order_workspace(d, N, G, gs, L, T, device, kparts=None):
    """``(plan, workspace, counters)`` for the orders of one pass: the
    layout of :func:`taylor_plan` on ``device``'s card (``kparts`` passed
    on) and, where it splits the contraction, the partial sums' workspace
    and the tiles' arrival counts (zero; each launch leaves them zero)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    plan = taylor_plan(d, N, G, gs, L, T, sms, kparts)
    _require(plan is not None,
             f"the Taylor-order kernel is not built for gs={gs}, L={L}, "
             f"T={T}")
    ws = counters = None
    split = plan["tiles"] - plan["full"]
    if split:
        ws = torch.empty(split * plan["kparts"] * plan["sums"] * THREADS,
                         dtype=torch.complex64, device=device)
        counters = torch.zeros(split, dtype=torch.int32, device=device)
    return plan, ws, counters


def taylor_pass(H0, ops, coeffs, dM, chis, dt, h, n_orders, per, work=None,
                hm_last=False):
    """The ``n_orders`` orders of one Taylor pass from ``Hm_1 = chis``, one
    :func:`taylor_order` call an order (one kernel launch on the card),
    in ``chis``' precision.

    Args:
      H0, ops, coeffs, dM, per: as for :func:`taylor_order` (the tables in
        ``chis``' real precision)
      chis: (N, K, d) co-states; dt: (N,) real step lengths; h: the
        recursion's scale (``coef[m - 1, n] = (i dt_n h)^m / m!``)
      work: ``(plan, workspace, counters)`` from :func:`order_workspace`
        for CUDA tensors, made here when None
      hm_last: write ``Hm_{n_orders + 1}`` at the last order too (checks;
        the pass itself does not need it)

    Returns ``(acc, φ_M, Hm, coef_M)``: the unscaled sum ``Σ_m coef_m
    φ_m``, the last order's ``φ``, the last ``Hm`` written (``Hm_{M+1}``
    with ``hm_last``, else ``Hm_M``; ``chis`` itself at ``M = 1``) and the
    last order's coefficients ``(N,)``.
    """
    N, K, d = chis.shape
    L = dM.shape[-1]
    cdt, dev = chis.dtype, chis.device
    rdt = chis.real.dtype
    cdt_n = (1j * dt.to(rdt) * h).to(cdt)
    m_all = torch.arange(1, n_orders + 1, dtype=rdt, device=dev)
    coef = torch.cumprod(cdt_n[None, :] / m_all[:, None], dim=0)
    phi = [torch.empty((N, K, L, d), dtype=cdt, device=dev)
           for _ in range(2)]
    hm = [torch.empty((N, K, d), dtype=cdt, device=dev) for _ in range(2)]
    acc = torch.empty((N, K, L, d), dtype=cdt, device=dev)
    if work is None and dev.type == "cuda" and not plain_forced():
        G, T = ops.shape[0], ops.shape[1]
        work = order_workspace(d, N, G, K // G, L, T, dev)
    hm_in = chis.contiguous()
    for m in range(1, n_orders + 1):
        write_hm = hm_last or m < n_orders
        taylor_order(H0, ops, coeffs, dM, coef[m - 1], phi[(m - 1) % 2],
                     hm_in, phi[m % 2], hm[m % 2], acc, 1.0 / h, per, m == 1,
                     write_hm, work=work)
        if write_hm:
            hm_in = hm[m % 2]
    return acc, phi[n_orders % 2], hm_in, coef[n_orders - 1]
