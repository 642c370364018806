"""The Taylor pass one order a call (``ops/hopper_taylor.py``) on the CPU:
its plain version through a whole pass, with the ``Hm`` chain one order
ahead of ``φ``, against the static-operator einsum pass of
``fg._backward_vectorized`` and against the reference's
``_backward_vectorized`` on bit-identical inputs; the order loop
(``taylor_pass``) against its orders written out; the route rule (also
with the kernels turned off); the layout rule and its forced split; the
order counters (also under ``plain_versions()``).

- d ∈ {128, 136} (136: a ragged row tile and chunk on the card), three
  layouts: one shared generator (G = 1 × gs = 4), two groups of two
  (G = 2 × gs = 2), one coefficient table a trajectory (``per_traj_coeffs``,
  G = K = 2); L = T = 2.
- complex128: to 1e-12 of the largest gradient entry (the same sums in
  another order: the generator formed before it is applied, the μ†
  products of an order taken from its input).
- complex64: the two float32 passes each within 2e-4 of the largest
  entry of the complex128 gradient, and within 2e-4 of each other; the
  series runs some 25 orders of float32 products of length d with
  entries of size about one, so each pass carries a rounding error of
  order 1e-5 relative, which the limit holds with room.
"""

import math

import numpy as np
import pytest
import torch

import grape_tpu
from grape_tpu import fg as ref_fg
from grape_tpu.fg import compile_problem as ref_compile_problem
from grape_tpu.functionals import J_T_sm as ref_J_T_sm

from grape_tpu_torch import compiled_problem_from_numpy
from grape_tpu_torch import fg as port_fg
from grape_tpu_torch.ops import hopper_taylor

from tests.test_torch_ensemble_fg import _arrays_of

torch.set_num_threads(1)

N_STEPS = 6
LAYOUTS = ("shared", "grouped", "per_traj_coeffs")


def _herm(rng, d, scale):
    A = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    return scale * 0.5 * (A + A.conj().T) / np.sqrt(d)


def _unit(rng, d):
    v = rng.normal(size=d) + 1j * rng.normal(size=d)
    return v / np.linalg.norm(v)


def _trajectories(layout, d):
    """Two controls (L = T = 2) on d levels: four trajectories under one
    generator, four in two groups of two, or two under one operator set
    with an amplitude shape of their own."""
    pkg = grape_tpu
    rng = np.random.default_rng(7 + d)

    def eps1(t):
        return 0.3 * np.cos(0.7 * t)

    def eps2(t):
        return 0.2 * np.sin(1.1 * t)

    H0, A, B = _herm(rng, d, 1.0), _herm(rng, d, 0.5), _herm(rng, d, 0.5)
    if layout == "shared":
        H = pkg.hamiltonian(H0, (A, eps1), (B, eps2))
        gens = [H] * 4
    elif layout == "grouped":
        Ha = pkg.hamiltonian(H0, (A, eps1), (B, eps2))
        Hb = pkg.hamiltonian(1.05 * H0, (A, eps1), (B, eps2))
        gens = [Ha, Ha, Hb, Hb]
    else:
        gens = [pkg.hamiltonian(
            H0, (A, pkg.ShapedAmplitude(eps1, lambda t, k=k: 1.0 + 0.1 * k)),
            (B, eps2)) for k in range(2)]
    trajs = [pkg.Trajectory(_unit(rng, d), H, target_state=_unit(rng, d))
             for H in gens]
    return trajs, np.linspace(0.0, 1.0, N_STEPS + 1)


def _setup(layout, d, dtype):
    """The reference's problem and the port's, the port's device constants,
    coefficient tables at a perturbed pulse, and seeded states, co-states
    and weights."""
    trajs, tlist = _trajectories(layout, d)
    cp_ref = ref_compile_problem(trajs, tlist, J_T=ref_J_T_sm, dtype=dtype,
                                 gradient_method="taylor", use_pallas=False)
    cp = compiled_problem_from_numpy(
        _arrays_of(cp_ref), device="cpu", J_T="J_T_sm",
        gradient_method="taylor",
    )
    consts = port_fg._device_constants(cp, torch.device("cpu"))
    G = consts["H0"].shape[0]
    want_G = {"shared": 1, "grouped": 2, "per_traj_coeffs": 2}[layout]
    assert G == want_G and cp.per_traj_coeffs == (layout == "per_traj_coeffs")
    rng = np.random.default_rng(11)
    L, N, K = cp.n_controls, cp.n_timesteps, cp.n_traj
    eps = np.asarray(cp.guess_pulsevals) + 0.05 * rng.normal(size=(L, N))
    coeffs, dM = port_fg._coeff_tables(
        cp, consts, torch.as_tensor(eps, dtype=consts["rdtype"]))
    psis = rng.normal(size=(N, K, d)) + 1j * rng.normal(size=(N, K, d))
    chis = rng.normal(size=(N, K, d)) + 1j * rng.normal(size=(N, K, d))
    psis /= np.linalg.norm(psis, axis=-1, keepdims=True)
    chis /= np.linalg.norm(chis, axis=-1, keepdims=True)
    rho = 0.5 + rng.random(K)
    return cp_ref, cp, consts, eps, coeffs, dM, psis, chis, rho


def _passes(layout, d, dtype):
    """``{"by_order", "static", "reference"}`` gradients ``(N, K, L)`` of
    the three passes on one set of inputs, and their ``taylor_ok``."""
    cp_ref, cp, consts, eps, coeffs, dM, psis, chis, rho = _setup(
        layout, d, dtype)
    cdt = consts["cdtype"]
    t = {key: torch.as_tensor(x, dtype=cdt) for key, x in
         (("psis", psis), ("chis", chis))}
    rho_t = torch.as_tensor(rho, dtype=consts["rdtype"])
    n_orders = port_fg._vectorized_taylor_orders(cp)
    assert n_orders == ref_fg._vectorized_taylor_orders(cp_ref)
    T = consts["ops"].shape[1]
    K, L = cp.n_traj, cp.n_controls
    G = consts["H0"].shape[0]
    assert port_fg._taylor_pass_route(d, K, G, L, T, cdt, "cpu") == "static"
    g_static, ok_static = port_fg._backward_vectorized(
        cp, consts, coeffs, dM, t["psis"], t["chis"], rho_t, None, n_orders)
    h = max(port_fg._h_norm_bound(cp, None), 1e-30)
    g_order, ok_order = port_fg._taylor_pass_by_order(
        cp, consts, coeffs, dM, t["psis"], t["chis"], rho_t, h, n_orders)
    tables = ref_fg._coeff_tables(cp_ref, np.asarray(eps))
    g_ref, ok_ref = ref_fg._backward_vectorized(
        cp_ref, tables, psis.astype(dtype), chis.astype(dtype),
        rho.astype(np.dtype(dtype).type(0).real.dtype), None)
    assert bool(ok_static) and bool(ok_order) and bool(ok_ref)
    return {"by_order": g_order.numpy(), "static": g_static.numpy(),
            "reference": np.asarray(g_ref)}


@pytest.mark.parametrize("d", [128, 136])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_by_order_pass_complex128(layout, d):
    g = _passes(layout, d, np.complex128)
    scale = np.max(np.abs(g["static"]))
    assert scale > 0
    assert g["by_order"].shape == g["static"].shape == g["reference"].shape
    assert np.max(np.abs(g["by_order"] - g["static"])) < 1e-12 * scale
    assert np.max(np.abs(g["by_order"] - g["reference"])) < 1e-12 * scale


@pytest.mark.parametrize("layout", LAYOUTS)
def test_by_order_pass_complex64(layout):
    exact = _passes(layout, 136, np.complex128)["static"]
    g = _passes(layout, 136, np.complex64)
    scale = np.max(np.abs(exact))
    for key in ("by_order", "static", "reference"):
        assert g[key].dtype == np.complex64
        assert np.max(np.abs(g[key] - exact)) < 2e-4 * scale, key
    assert np.max(np.abs(g["by_order"] - g["static"])) < 2e-4 * scale


@pytest.mark.parametrize("first,write_hm", [(True, True), (False, True),
                                            (False, False)])
def test_order_plain_against_the_einsum_order(first, write_hm):
    """One order of the plain version against the static-operator algebra
    written out: ``φ_m = A φ_{m-1} + μ† Hm_m``, ``Hm_{m+1} = A Hm_m``,
    ``acc += coef φ_m``, in place, ``hm_out`` untouched when not
    written."""
    rng = np.random.default_rng(5)
    G, gs, T, L, d, N = 2, 2, 3, 2, 9, 4
    K = G * gs

    def c(*shape):
        return torch.as_tensor(rng.normal(size=shape)
                               + 1j * rng.normal(size=shape))

    H0, ops = c(G, d, d), c(G, T, d, d)
    co = torch.as_tensor(rng.normal(size=(N, T)))
    dM = torch.as_tensor(rng.normal(size=(N, T, L)))
    coef = c(N)
    phi_in, hm_in, acc0 = c(N, K, L, d), c(N, K, d), c(N, K, L, d)
    phi_out = torch.zeros_like(phi_in)
    hm_out = torch.full_like(hm_in, 7.0)
    acc = acc0.clone()
    inv_h = 0.25
    hopper_taylor.taylor_order(H0, ops, co, dM, coef, phi_in, hm_in,
                               phi_out, hm_out, acc, inv_h, False, first,
                               write_hm)
    Hd = (H0[None] + torch.einsum("nt,gtij->ngij", co.to(H0.dtype), ops)
          ).conj().transpose(-1, -2) * inv_h  # (N, G, d, d)
    opsd = ops.conj().transpose(-1, -2)
    hg = hm_in.reshape(N, G, gs, d)
    mu = torch.einsum("ntl,ngsti->ngsli", dM.to(H0.dtype),
                      torch.einsum("gtij,ngsj->ngsti", opsd, hg))
    want = mu.reshape(N, K, L, d)
    if not first:
        want = want + torch.einsum(
            "ngij,ngslj->ngsli", Hd,
            phi_in.reshape(N, G, gs, L, d)).reshape(N, K, L, d)
    assert torch.allclose(phi_out, want, rtol=0, atol=1e-11)
    want_acc = coef[:, None, None, None] * want + (0 if first else acc0)
    assert torch.allclose(acc, want_acc, rtol=0, atol=1e-11)
    if write_hm:
        want_hm = torch.einsum("ngij,ngsj->ngsi", Hd, hg).reshape(N, K, d)
        assert torch.allclose(hm_out, want_hm, rtol=0, atol=1e-11)
    else:
        assert bool((hm_out == 7.0).all())


# name -> (d, K, G, L, T, N_T, dtype, device type, route)
ROUTES = {
    # cz.taylor: dim 100 takes the formed-H_n branch on every device
    "cz_taylor_cuda": (100, 4, 1, 4, 4, 2000, torch.complex64, "cuda",
                       "formed"),
    # cz1024.cheby: dim 1024, 4 basis states, 4 controls and terms
    "cz1024_cuda": (1024, 4, 1, 4, 4, 100, torch.complex64, "cuda",
                    "kernel"),
    "cz1024_complex128": (1024, 4, 1, 4, 4, 100, torch.complex128, "cuda",
                          "static"),
    "cz1024_cpu": (1024, 4, 1, 4, 4, 100, torch.complex64, "cpu", "static"),
    "grouped_d256": (256, 8, 2, 4, 4, 200, torch.complex64, "cuda",
                     "kernel"),
    "per_traj_d256": (256, 4, 4, 4, 4, 200, torch.complex64, "cuda",
                      "kernel"),
    # odd d: rows not on 16 bytes, the static branch
    "odd_d": (1025, 4, 1, 4, 4, 100, torch.complex64, "cuda", "static"),
    # one to four controls, one operator each
    "one_control": (256, 4, 1, 1, 1, 50, torch.complex64, "cuda", "kernel"),
    "three_controls": (256, 2, 1, 3, 3, 50, torch.complex64, "cuda",
                       "kernel"),
    # layouts the kernel is not built for: two controls on three terms,
    # a group of eight
    "unbuilt_layout": (256, 4, 1, 2, 3, 50, torch.complex64, "cuda",
                       "static"),
    "group_of_8": (256, 8, 1, 1, 1, 50, torch.complex64, "cuda", "static"),
    # too many columns for the static branch
    "many_columns": (256, 16, 1, 4, 4, 50, torch.complex64, "cuda",
                     "formed"),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_taylor_pass_route(name):
    d, K, G, L, T, N, dtype, device, route = ROUTES[name]
    assert port_fg._taylor_pass_route(d, K, G, L, T, dtype, device) == route


@pytest.mark.parametrize("name", ["cz_taylor_cuda", "cz1024_cuda",
                                  "grouped_d256"])
def test_taylor_pass_route_kernels_off(name):
    """``use_pallas=False`` (``_kernels_enabled`` False) launches no
    kernel: the kernel's shapes take the static einsums, the rest stay."""
    d, K, G, L, T, N, dtype, device, route = ROUTES[name]
    want = "static" if route == "kernel" else route
    assert port_fg._taylor_pass_route(d, K, G, L, T, dtype, device,
                                      False) == want


@pytest.mark.parametrize("d,N,G,gs,tiles,full,kparts", [
    # cz1024.cheby: 13 step blocks x 16 row blocks = 208 tiles on 132 SMs:
    # 132 whole, the other 76 in 5 ranges (380 CTAs, 3 waves of a fifth)
    (1024, 100, 1, 4, 208, 132, 5),
    # two groups: 416 = 3 waves and 20, those 20 in 6 ranges (one wave)
    (1024, 100, 2, 4, 416, 396, 6),
    # 25 step blocks x 4 row blocks: under one wave; 16 chunks allow 2
    # ranges of 8, which would take a second wave: not split
    (256, 200, 1, 4, 100, 100, 1),
    # a ragged row tile: 3 row blocks of 64 for d = 136, 1 step block, 2
    # groups; 9 chunks are too few to split
    (136, 6, 2, 2, 6, 6, 1),
])
def test_taylor_plan(d, N, G, gs, tiles, full, kparts):
    plan = hopper_taylor.taylor_plan(d, N, G, gs, 4, 4)
    assert plan["tiles"] == tiles and plan["full"] == full
    assert plan["kparts"] == kparts
    assert plan["sums"] == 2 * gs * 9
    assert plan["smem"] <= 227 * 1024
    assert hopper_taylor.taylor_plan(d, N, G, gs, 2, 3) is None
    assert hopper_taylor.taylor_plan(d + 1, N, G, gs, 4, 4) is None


@pytest.mark.parametrize("kparts,full", [(1, 208), (3, 132), (8, 132)])
def test_taylor_plan_forced_split(kparts, full):
    """A ``kparts`` given replaces the rule's choice (5 at cz1024.cheby's
    shapes); 1 runs every tile whole."""
    plan = hopper_taylor.taylor_plan(1024, 100, 1, 4, 4, 4, kparts=kparts)
    assert plan["kparts"] == kparts and plan["full"] == full
    assert plan["tiles"] == 208


@pytest.mark.parametrize("hm_last", [False, True])
def test_taylor_pass_orders(hm_last):
    """``hopper_taylor.taylor_pass`` against its orders written out: the
    sum ``Σ_m coef_m φ_m`` with ``coef_m = (i dt h)^m / m!``, the last
    ``φ``, ``Hm = A^{M-1} χ`` (``A^M χ`` with ``hm_last``) and the last
    coefficients."""
    rng = np.random.default_rng(9)
    G, gs, T, L, d, N, M = 1, 2, 2, 3, 7, 3, 4
    K = G * gs

    def c(*shape):
        return torch.as_tensor(rng.normal(size=shape)
                               + 1j * rng.normal(size=shape))

    H0, ops, chis = c(G, d, d), c(G, T, d, d), c(N, K, d)
    co = torch.as_tensor(rng.normal(size=(N, T)))
    dM = torch.as_tensor(rng.normal(size=(N, T, L)))
    dt = torch.as_tensor(0.1 + rng.random(N))
    h = 3.0
    acc, phi, hm, coef = hopper_taylor.taylor_pass(
        H0, ops, co, dM, chis, dt, h, M, False, hm_last=hm_last)
    A = (H0[None] + torch.einsum("nt,gtij->ngij", co.to(H0.dtype), ops)
         ).conj().transpose(-1, -2)[:, 0] / h  # (N, d, d)
    mu = torch.einsum("ntl,tji->ntlij", dM.to(H0.dtype), ops[0].conj())
    mu = mu.sum(1)  # (N, L, d, d): μ_nl† = Σ_t dM[n, t, l] Op_t†
    want_acc = torch.zeros_like(acc)
    p = None
    x = chis
    for m in range(1, M + 1):
        q = torch.einsum("nlij,nkj->nkli", mu, x)
        p = q if p is None else q + torch.einsum("nij,nklj->nkli", A, p)
        cm = (1j * dt * h) ** m / math.factorial(m)
        want_acc = want_acc + cm[:, None, None, None] * p
        if m < M or hm_last:
            x = torch.einsum("nij,nkj->nki", A, x)
    scale = float(want_acc.abs().max())
    assert float((acc - want_acc).abs().max()) < 1e-12 * scale
    assert float((phi - p).abs().max()) < 1e-12 * float(p.abs().max())
    assert float((hm - x).abs().max()) < 1e-12 * float(x.abs().max())
    assert torch.allclose(coef, cm, rtol=1e-14, atol=0)


def test_order_counters_plain_versions(monkeypatch):
    """Under ``plain_versions()`` the kernel's route runs its plain
    version, and its orders count in ``total`` but not in ``kernel``."""
    from grape_tpu_torch.ops import plain_versions

    _, cp, consts, _, coeffs, dM, psis, chis, rho = _setup(
        "shared", 128, np.complex128)
    args = (cp, consts, coeffs, dM, torch.as_tensor(psis),
            torch.as_tensor(chis), torch.as_tensor(rho), None)
    n = port_fg._vectorized_taylor_orders(cp)
    monkeypatch.setattr(port_fg, "_taylor_pass_route",
                        lambda *a: "kernel")
    counts = dict(port_fg.taylor_orders)
    with plain_versions():
        _, ok = port_fg._backward_vectorized(*args, n)
    assert bool(ok)
    assert port_fg.taylor_orders["total"] == counts["total"] + n
    assert port_fg.taylor_orders["kernel"] == counts["kernel"]


def test_order_counters_share(monkeypatch):
    """``taylor_orders["kernel"]`` counts the orders of the passes that
    took the kernel's route: none on the CPU, all of them where the route
    says ``"kernel"`` (patched here so that the by-order pass runs its
    plain version through ``_backward_vectorized``)."""
    _, cp, consts, _, coeffs, dM, psis, chis, rho = _setup(
        "shared", 128, np.complex128)
    args = (cp, consts, coeffs, dM, torch.as_tensor(psis),
            torch.as_tensor(chis), torch.as_tensor(rho), None)
    n = port_fg._vectorized_taylor_orders(cp)
    counts = dict(port_fg.taylor_orders)
    g_static, _ = port_fg._backward_vectorized(*args, n)
    assert port_fg.taylor_orders["kernel"] == counts["kernel"]
    assert port_fg.taylor_orders["total"] == counts["total"] + n
    monkeypatch.setattr(port_fg, "_taylor_pass_route",
                        lambda *a: "kernel")
    g_kernel, ok = port_fg._backward_vectorized(*args, n)
    assert bool(ok)
    got = {k: port_fg.taylor_orders[k] - counts[k] for k in counts
           if k != "last"}
    assert got == {"total": 2 * n, "kernel": n}
    assert got["kernel"] / got["total"] == 0.5
    scale = float(g_static.abs().max())
    assert float((g_kernel - g_static).abs().max()) < 1e-12 * scale
