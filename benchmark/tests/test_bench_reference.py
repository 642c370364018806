"""The plain reference agrees with ``grape_tpu_torch`` run with
``device="cpu"`` in complex128, on both configurations at a tiny size (dim
9, N_T = 20, 2 samples), and its gradient with central differences.  This
file may import the port; the reference may not."""

import numpy as np
import pytest
import torch

from benchmark import programs, reference
from benchmark.harness import inputs, spec

torch.set_num_threads(1)
CONFIGS = ["cz_transmon_d100", "cz_ensemble_d100"]
CELL = {"cz_transmon_d100": "cz.gradgen",
        "cz_ensemble_d100": "ensemble32.recompute"}


def tiny(name):
    sp = spec.cell_spec(CELL[name])
    cfg = dict(sp["config"], levels=3, n_steps=20, T=4.0)
    if cfg["n_samples"] > 1:
        cfg["n_samples"] = 2
    return cfg, sp["traffic"]


def pulses(cfg, traffic, seed):
    # a guess with larger values than the cells', so that the controls
    # matter at this short T
    return inputs.guess(cfg, traffic, seed, 0) * 8.0


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("method", ["gradgen", "taylor"])
def test_reference_agrees_with_the_port(name, method):
    import grape_tpu_torch as gt

    cfg, traffic = tiny(name)
    seed = 2**31 + 7
    raw = inputs.draw(cfg, seed)
    x = pulses(cfg, traffic, seed)
    problem = programs.load(cfg["kind"]).Program(cfg, raw).problem(x)
    cp = gt.compile_problem(problem.trajectories, problem.tlist,
                            gradient_method=method, device="cpu",
                            dtype=np.complex128, **problem.kwargs)
    assert cp.n_controls == 4 and cp.dim == 9
    assert cp.n_traj == 4 * cfg["n_samples"]
    np.testing.assert_array_equal(np.asarray(cp.guess_pulsevals), x)
    J, G, _ = gt.build_fg(cp)(x.reshape(-1))
    ref = reference.load(cfg["kind"]).Reference(cfg, raw, "cpu")
    J_ref, g_ref = ref.value_and_grad(x)
    assert 0.05 < J_ref < 1.0
    assert abs(float(J) - J_ref) < 1e-12
    g = np.asarray(G, dtype=np.float64)
    assert np.max(np.abs(g - g_ref)) < 1e-10 * np.max(np.abs(g_ref))


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_gradient_against_central_differences(name):
    cfg, traffic = tiny(name)
    raw = inputs.draw(cfg, 5)
    x = pulses(cfg, traffic, 5)
    ref = reference.load(cfg["kind"]).Reference(cfg, raw, "cpu")
    _, g = ref.value_and_grad(x)
    h = 1e-6
    for idx in [(0, 3), (1, 10), (3, 19)]:
        xp, xm = x.copy(), x.copy()
        xp[idx] += h
        xm[idx] -= h
        fd = (ref.value_and_grad(xp)[0] - ref.value_and_grad(xm)[0]) / (2 * h)
        assert abs(fd - g.reshape(x.shape)[idx]) < 1e-7


def test_reference_windows_give_the_same_numbers():
    cfg, traffic = tiny("cz_ensemble_d100")
    raw = inputs.draw(cfg, 9)
    x = pulses(cfg, traffic, 9)
    kind = reference.load(cfg["kind"])
    J1, g1 = kind.Reference(cfg, raw, "cpu").value_and_grad(x)
    J2, g2 = kind.Reference(cfg, raw, "cpu",
                            window_items=6).value_and_grad(x)
    assert abs(J1 - J2) < 1e-13
    assert np.max(np.abs(g1 - g2)) < 1e-12


def test_seed_draws_are_reproducible_and_sized_alike():
    cfg, traffic = tiny("cz_ensemble_d100")
    big = 2**31 + 12345
    np.testing.assert_array_equal(inputs.draw(cfg, big)["detunings"],
                                  inputs.draw(cfg, big)["detunings"])
    assert np.all(np.abs(inputs.draw(cfg, big)["detunings"]) <= 0.02)
    # the same samples for every seed, in the seed's order
    a, b = inputs.draw(cfg, 0)["detunings"], inputs.draw(cfg, big)["detunings"]
    assert sorted(map(tuple, a)) == sorted(map(tuple, b))
    # the ensemble cells solve one guess, the CZ cells a pool of them
    assert traffic["guess"]["pool"] == 1
    cfg, traffic = tiny("cz_transmon_d100")
    assert traffic["guess"]["pool"] > 1
    peaks = [np.max(np.abs(inputs.guess(cfg, traffic, s, i)), axis=1)
             for s in (0, big) for i in (0, 1)]
    peaks.append(np.max(np.abs(inputs.warmup_guess(cfg, traffic, big)),
                        axis=1))
    for p in peaks:
        np.testing.assert_allclose(p, peaks[0], rtol=1e-12)
    assert not np.array_equal(inputs.guess(cfg, traffic, 0, 0),
                              inputs.guess(cfg, traffic, 0, 1))
    # every seed solves the same pool of guesses, in its own order
    pool = int(traffic["guess"]["pool"])

    def members(seed):
        return sorted(inputs.guess(cfg, traffic, seed, i).tobytes()
                      for i in range(pool))

    assert members(0) == members(big)
    assert len(set(members(0))) == pool
    np.testing.assert_array_equal(inputs.guess(cfg, traffic, 3, 1),
                                  inputs.guess(cfg, traffic, 3, 1 + pool))
