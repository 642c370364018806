"""The device-resident loop (``optimizer="device-lbfgs"``) of
``grape_tpu_torch`` against ``grape_tpu``.

The cases of the reference's ``tests/test_device_loop.py`` on the port, in
complex128 on the CPU (the sharded one is
``tests/test_torch_distributed.py::test_device_loop_sharded_matches_plain``):
the J_T series within 1e-8 of its scale (its first value) of
the reference's over 8 iterations under bounds, with the same evaluation
count (without bounds the values reach rounding level, where the two line
searches part by an evaluation), one
iteration a chunk against four bit for bit, the surplus iterations of a
chunk discarded at convergence, bounds, the envelope grown mid-chunk, the
``"auto"`` schedule (a probe chunk, then the full chunk; back to one after a
callback's pulse mutation) and the ``"auto"`` backend with CUDA faked
(the host loop: the decision measured on the card).  The
reference's duration guard is left out, so the schedule does not depend on
the machine's load.  A ``torch.optim`` optimizer inside the chunk
(``transformation=``) follows the host ``torch.optim`` backend.
"""

import functools

import numpy as np
import pytest
import torch

import grape_tpu

import grape_tpu_torch as gt
from grape_tpu_torch.controls import discretize_on_midpoints
from grape_tpu_torch.optimizers.device_loop import DeviceLoopBackend
from grape_tpu_torch.workspace import GrapeWrk

torch.set_num_threads(1)

SZ = np.array([[1, 0], [0, -1]], dtype=complex)
SX = np.array([[0, 1], [1, 0]], dtype=complex)


def _tls(pkg, n_points=201, amp=0.2):
    def eps(t):
        return amp * float(gt.shapes.flattop(t, T=5, t_rise=0.3,
                                             func="blackman"))

    H = pkg.hamiltonian(-0.5 * SZ, (SX, eps))
    return ([pkg.Trajectory([1, 0], H, target_state=[0, 1])],
            np.linspace(0, 5, n_points))


def _run(pkg=gt, n_points=201, amp=0.2, callback=None, **kw):
    """``optimize`` of ``pkg`` on the TLS: ``(result, J_T series)``."""
    trajs, tlist = _tls(pkg, n_points, amp)
    series = []
    cbs = [lambda wrk, i: series.append(float(wrk.result.J_T))]
    if callback is not None:
        cbs.append(callback)
    extra = {"device": "cpu"} if pkg is gt else {}
    res = pkg.optimize(trajs, tlist, J_T=pkg.functionals.J_T_sm,
                       print_iters=False, rethrow_exceptions=True,
                       callback=cbs, **extra, **kw)
    return res, np.asarray(series)


def _pulse(res):
    return discretize_on_midpoints(res.optimized_controls[0], res.tlist)


# with bounds: the projection's re-evaluation is held too, and J_T stays
# near 0.05 over the 8 iterations, far from rounding level
PARITY = dict(n_points=101, iter_stop=8, optimizer="device-lbfgs",
              device_loop_iters=4, lower_bound=-0.5, upper_bound=0.5)


@pytest.fixture(scope="module")
def ref_device_loop():
    return _run(grape_tpu, **PARITY)


def test_device_loop_matches_the_reference(ref_device_loop):
    res, series = _run(**PARITY)
    ref, ref_series = ref_device_loop
    assert len(series) == len(ref_series) == 9
    np.testing.assert_allclose(series, ref_series, rtol=0,
                               atol=1e-8 * ref_series[0])
    assert res.fg_calls == ref.fg_calls and res.f_calls == ref.f_calls
    np.testing.assert_allclose(_pulse(res), _pulse(ref), atol=1e-8)
    assert np.max(np.abs(_pulse(res))) <= 0.5 + 1e-12


def test_device_loop_converges_and_reports_iterations():
    trace = []
    res, _ = _run(iter_stop=20, optimizer="device-lbfgs",
                  device_loop_iters=5,
                  callback=lambda w, i: trace.append(i))
    assert res.J_T < 1e-3
    assert trace == list(range(res.iter + 1))
    assert res.fg_calls >= res.iter


def test_device_loop_chunking_invariance():
    """One iteration a chunk and four: the same math, bit for bit."""
    kw = dict(n_points=101, iter_stop=8, optimizer="device-lbfgs")
    res_1, tr_1 = _run(device_loop_iters=1, **kw)
    res_4, tr_4 = _run(device_loop_iters=4, **kw)
    assert len(tr_1) == len(tr_4) == 9
    np.testing.assert_array_equal(tr_4, tr_1)
    np.testing.assert_array_equal(_pulse(res_4), _pulse(res_1))
    assert res_1.fg_calls == res_4.fg_calls
    assert tr_4[5] < 1e-3


def test_device_loop_convergence_check_discards_surplus():
    res, _ = _run(iter_stop=50, optimizer="device-lbfgs",
                  device_loop_iters=7,
                  check_convergence=lambda r: (
                      "J_T < 10⁻³" if r.J_T < 1e-3 else ""))
    assert res.converged and res.message == "J_T < 10⁻³"
    assert res.J_T < 1e-3 and res.iter < 7
    # the reported pulse belongs to the convergence iterate
    trajs, tlist = _tls(gt)
    cp = gt.compile_problem(trajs, tlist, J_T=gt.functionals.J_T_sm,
                            device="cpu")
    J_check, _, _ = gt.build_fg(cp)(_pulse(res))
    np.testing.assert_allclose(float(J_check), res.J_T, atol=1e-9)


def test_device_loop_native_linesearch_efficiency():
    """The L-BFGS + Moré–Thuente search spends about one fg evaluation an
    iteration on the CNOT problem (the reference's anchor: at most two).
    ExpProp here, where the reference takes the problem's Chebyshev
    propagator: the port's per-step Chebyshev series on the CPU would take
    most of a minute."""
    p = gt.testing.cnot_problem()
    kw = dict(p.kwargs, prop_method="expprop")
    series = []
    res = gt.optimize(p.trajectories, p.tlist, iter_stop=25,
                      optimizer="device-lbfgs", device_loop_iters=5,
                      print_iters=False, rethrow_exceptions=True,
                      device="cpu",
                      callback=lambda w, i: series.append(w.result.J_T),
                      **kw)
    assert res.iter == 25
    assert res.J_T < 0.5 * series[0]
    assert res.fg_calls <= 2.0 * res.iter + 2, (res.fg_calls, res.iter)


def test_device_loop_bounds_projection():
    res, _ = _run(iter_stop=25, optimizer="device-lbfgs",
                  device_loop_iters=5, lower_bound=-0.5, upper_bound=0.5)
    assert np.max(np.abs(_pulse(res))) <= 0.5 + 1e-12
    assert res.J_T < 0.5


def test_device_loop_envelope_growth_mid_chunk(monkeypatch):
    """A tiny guess (small envelope bucket) whose optimum peaks near 0.8:
    the stale iterates of a chunk are discarded, the bucket grown and the
    run re-seeded; it converges as the host backends do."""
    wrks = []
    orig_init = GrapeWrk.__init__

    def spy_init(self, *a, **kw):
        orig_init(self, *a, **kw)
        wrks.append(self)

    monkeypatch.setattr(GrapeWrk, "__init__", spy_init)
    seeds = []
    orig_seed = DeviceLoopBackend._init_state

    def spy_seed(self, x):
        seeds.append(x.clone())
        return orig_seed(self, x)

    monkeypatch.setattr(DeviceLoopBackend, "_init_state", spy_seed)
    res, _ = _run(amp=0.05, iter_stop=40, optimizer="device-lbfgs",
                  device_loop_iters=4, prop_method="cheby",
                  gradient_method="taylor",
                  check_convergence=lambda r: r.J_T < 1e-3)
    wrk = wrks[-1]
    assert res.J_T < 1e-3
    assert wrk._amp_bucket is not None and max(wrk._amp_bucket) >= 0.8
    assert len(seeds) >= 2  # a chunk's stale iterate re-seeded the run
    assert np.max(np.abs(_pulse(res))) <= max(wrk._amp_bucket) + 1e-12


def _spy_launches(backend):
    """The size of every chunk the backend launches."""
    sizes = []
    orig = backend._make_chunk

    def spy(wrk, n_iters=None):
        fn = orig(wrk, n_iters)

        def logged(*args, _n=n_iters, **kw):
            sizes.append(_n)
            return fn(*args, **kw)

        return logged

    backend._make_chunk = spy
    return sizes


BOUNDS = dict(upper_bound=1.0, lower_bound=-1.0)


def test_device_loop_auto_chunk_schedule():
    """A probe chunk of one iteration, then the full chunk; the same math
    as one iteration a chunk."""
    backend = DeviceLoopBackend(chunk_iters=8, chunk_schedule="auto")
    sizes = _spy_launches(backend)
    res, tr_auto = _run(n_points=101, iter_stop=7, optimizer=backend,
                        **BOUNDS)
    assert sizes == [1, 8]
    _, tr_fix = _run(n_points=101, iter_stop=7, optimizer="device-lbfgs",
                     device_loop_iters=1, **BOUNDS)
    assert len(tr_auto) == len(tr_fix) == 8
    np.testing.assert_array_equal(tr_auto, tr_fix)
    assert res.iter == 7


def test_device_loop_auto_schedule_resets_on_mutation():
    """A callback's pulse mutation cuts the chunk and is an eventful
    chunk: back to one iteration, then the full chunk again."""
    backend = DeviceLoopBackend(chunk_iters=8, chunk_schedule="auto")
    sizes = _spy_launches(backend)
    mutated = []

    def mutate_at_3(wrk, iteration):
        if iteration == 3:
            wrk.pulsevals *= 0.8
            mutated.append(wrk.pulsevals.copy())

    res, _ = _run(n_points=101, iter_stop=6, optimizer=backend,
                  callback=mutate_at_3, **BOUNDS)
    assert sizes == [1, 8, 1, 8]
    assert res.iter == 6 and len(mutated) == 1


def test_optimizer_auto_selection():
    """``"auto"``: the native L-BFGS-B on the CPU and, by the measured
    decision, on CUDA too (the reference takes the device loop on its TPU);
    with ``fw_prop_callback`` the host loop; a named backend as named."""
    from grape_tpu_torch.optimize import _get_optimizer as get
    from grape_tpu_torch.optimizers.lbfgsb import LBFGSB

    class FakeWrk:
        def __init__(self, kwargs, device="cpu", fw_cb=None):
            self.kwargs = kwargs
            self.cp = type("CP", (), {"device": torch.device(device),
                                      "fw_prop_callback": fw_cb})()

    for device in ("cpu", "cuda"):
        assert isinstance(get(FakeWrk({}, device)), LBFGSB)
        assert isinstance(get(FakeWrk({"optimizer": "auto"}, device)),
                          LBFGSB)
        assert isinstance(get(FakeWrk({}, device, lambda v, t: None)),
                          LBFGSB)
    named = get(FakeWrk({"optimizer": "device-lbfgs",
                         "device_loop_iters": 3}, "cuda"))
    assert isinstance(named, DeviceLoopBackend)
    assert named.chunk_iters == 3 and named.chunk_schedule == "fixed"
    assert get(FakeWrk({"optimizer": "device-lbfgs"})).chunk_iters == 10


def test_torch_optim_transformation_in_the_chunk():
    """``transformation=`` Adam inside the chunk: the same series as the
    host ``torch.optim`` backend's Adam, one evaluation an iteration."""
    adam = functools.partial(torch.optim.Adam, lr=0.05)
    # bounds fix the envelope: no re-seeding, which would reset the moments
    res_d, tr_d = _run(iter_stop=12, optimizer=DeviceLoopBackend(
        transformation=adam, chunk_iters=5), **BOUNDS)
    res_h, tr_h = _run(iter_stop=12, optimizer=adam, **BOUNDS)
    np.testing.assert_allclose(tr_d, tr_h, rtol=1e-12, atol=0)
    assert res_d.fg_calls == res_h.fg_calls == 13
    with pytest.raises(TypeError, match="torch.optim"):
        DeviceLoopBackend(transformation=object())
