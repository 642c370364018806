"""The frozen counts against the hand reckonings of the kernel table in
PERF.md (d = 100, T = 4 control terms, N_T = 2000, s = 0; K1-K3 K = 4, K4
G = 8 groups of 4)."""

import pytest

from benchmark.counts import (
    envelope, frechet, gradgen, peaks, propagators, state_scan, taylor,
)

D, T, N_T = 100, 4, 2000


def k1(K=4, G=1, s=0):
    prop = {"d": D, "G": G, "T": T, "N_T": N_T, "coeff_values": N_T * T,
            "s": s}
    scan = {"C": N_T, "G": G, "K": K, "d": D, "chi": False, "carry": False}
    return propagators.of_call(prop), state_scan.of_call(scan)


def test_k1_operations_and_bytes():
    (pf, pb), (sf, sb) = k1()
    assert (pf + sf) / 1e9 == pytest.approx(96.6, abs=0.05)
    # the whole scan reads H0, ops, coefficients, steps and psi0 and writes
    # U and the states once: U is not counted again as the apply's input
    U = 8 * N_T * D * D
    assert (pb + sb - U) / 1e6 == pytest.approx(167, abs=0.5)
    # the halves' bounds: propagators by operations, the apply by bytes
    assert peaks.bound(pf, pb) == (pytest.approx(1.433, abs=5e-4),
                                   "operations")
    assert peaks.bound(sf, sb)[1] == "bytes"
    assert peaks.bound(sf, sb)[0] == pytest.approx(0.050, abs=5e-4)


def test_k2_bytes_bound():
    fl, by = state_scan.of_call({"C": N_T, "G": 1, "K": 4, "d": D,
                                 "chi": True, "carry": False})
    assert fl == (N_T - 1) * 8.0 * 4 * D * D
    assert peaks.bound(fl, by) == (pytest.approx(0.0497, abs=1e-4), "bytes")


def test_k3_operations_and_bytes():
    shape = {"G": 1, "T": T, "d": D, "N_T": N_T, "K": 4,
             "coeff_values": N_T * T, "s": 0}
    fl, by = frechet.of_call(shape)
    assert fl / 1e9 == pytest.approx(32.8, abs=0.05)
    assert by / 1e6 == pytest.approx(13.5, abs=0.05)
    assert peaks.bound(fl, by) == (pytest.approx(0.489, abs=5e-4),
                                   "operations")


def test_k4_operations():
    (pf, _), (sf, _) = k1(K=32, G=8)
    assert (pf + sf) / 1e9 == pytest.approx(773.1, abs=0.05)
    assert peaks.bound(pf + sf, 1.33e9)[0] == pytest.approx(11.54, abs=0.01)


def test_k6_operations_at_group_size_4():
    assert frechet.flops(D, 8, 4, T, N_T, 0) / 1e9 == pytest.approx(
        262.4, abs=0.1)


@pytest.mark.parametrize("s", [0, 1, 3])
def test_frechet_takes_the_cheaper_algorithm(s):
    # the dense evaluation at d = 3 is cheaper than the factored one
    small = frechet.needed_flops(3, 4, 2, 10, s)
    dense = 10 * ((4.0 * 2 + 2) * 9 + (5 + s) * 8 * 27
                  + 4 * ((12 + 2 * s) * 8 * 27 + 2 * 8 * 9))
    assert small <= dense
    assert frechet.needed_flops(D, 4, T, N_T, s) < N_T * (
        (5 + s) * 8e6 + 4 * (12 + 2 * s) * 8e6)


def test_squarings_and_orders_grow_with_the_norm():
    assert envelope.squarings(1.9) == 0
    assert envelope.squarings(2.1) == 1
    assert envelope.squarings(8.0) == 2
    lo = envelope.taylor_orders(0.5, 0.1)
    hi = envelope.taylor_orders(2.0, 0.1)
    assert lo < hi
    assert envelope.taylor_orders(50.0, 1.0, max_order=10) is None


def test_evaluation_counts_add_their_parts():
    g = gradgen.evaluation_flops(D, 1, 4, T, N_T, 0)
    (pf, _), (sf, _) = k1()
    assert g == pytest.approx(pf + sf + (N_T - 1) * 8.0 * 4 * D * D
                              + frechet.needed_flops(D, 4, T, N_T, 0))
    t = taylor.evaluation_flops(D, 1, 4, 4, N_T, 0, 19)
    assert t == pytest.approx(pf + sf + (N_T - 1) * 8.0 * 4 * D * D
                              + taylor.pass_flops(D, 4, 4, N_T, 19))
    assert taylor.pass_flops(D, 4, 4, N_T, 20) > taylor.pass_flops(
        D, 4, 4, N_T, 19)
