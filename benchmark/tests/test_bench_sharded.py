"""A cell on several cards, on the CPU: its ranks as processes of a gloo
world of 2 and of 4 (``ranks_tiny.py``, ``benchmark/run.py``'s ``main`` at
the tiny size), in lockstep.  Rank 0's line is ``correct`` and counts the
world; ``rank_gap`` 0 says that every rank ended each solve at the same
iteration with the same bits at the checked iterates, so the window closed
at the same iteration on each.  A rank's gradient block left out of the
sum reads not correct, and so does each fault of ``test_bench_faults``
planted on every rank; a rank killed in the window ends every rank with
another code than 0 well within the collectives' timeout; a rank that
loaded a module of JAX makes rank 0 exit 3 and print no result.  Beside them the
pieces: the reference's blocks, ``rank_gap``, ``card_share`` and the
``collective_ms`` reader."""

import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark.harness import check, ranks, spec
from benchmark.tests.test_bench_faults import FAULTS

CELL = "ensemble128.sharded4"
SEED = 2**32 + 15
# seconds within which every rank of a run must have ended
RUN_LIMIT_S = 120


def _run(world, fault="", trace=0, seconds=2.0):
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.tests.ranks_tiny", "--world",
         str(world), "--fault", fault, "--workload", CELL, "--seed",
         str(SEED), "--seconds", str(seconds), "--trace", str(trace)],
        capture_output=True, text=True, timeout=RUN_LIMIT_S + 60,
        cwd=spec.ROOT)
    took = time.perf_counter() - t0
    pids = [int(p.split(":")[1]) for text in out.stderr.splitlines()
            if text.startswith("ranks ") and ":" in text
            for p in text.split()[1:]]
    return out, took, pids


def _line(out):
    return json.loads(out.stdout.strip().splitlines()[-1])


def _gone(pid, wait_s=10.0):
    """True once ``pid`` has exited (or is a zombie awaiting its reaper)."""
    end = time.perf_counter() + wait_s
    while time.perf_counter() < end:
        try:
            with open(f"/proc/{pid}/stat") as fh:
                if fh.read().rsplit(")", 1)[1].split()[0] in ("Z", "X"):
                    return True
        except (FileNotFoundError, ProcessLookupError):
            return True
        time.sleep(0.2)
    return False


@pytest.mark.parametrize("world", [2, 4])
def test_the_ranks_run_in_lockstep_and_rank_0_reports(world):
    out, took, pids = _run(world)
    assert out.returncode == 0, out.stderr[-3000:]
    line = _line(out)
    assert line["correct"] is True, out.stderr[-3000:]
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert line["device"]["count"] == world
    assert line["checks"]["rank_gap"] == {"value": 0.0, "limit": 0.0}
    assert set(line["metrics"]) == {"setup_s", "iters_per_s.sharded"}
    tail = out.stderr.strip().splitlines()
    assert tail[-1].startswith("rank_gap ")
    # each rank on cores of its own where the host has a core a rank
    held = [set(map(int, c.split(","))) for text in tail
            if text.startswith(f"ranks {world} ")
            for c in text.split(" cores ")[1].split(" decisions")[0].split()]
    assert len(held) == world
    if len(os.sched_getaffinity(0)) >= world:
        assert sum(map(len, held)) == len(set().union(*held))
    assert len(pids) == world - 1 and all(_gone(p) for p in pids)


def test_the_ranks_decide_alike_at_a_solves_end():
    # solves end at their cap of iterations before the window closes, so
    # the decision at each solve's end is read at once on every rank
    out, _, _ = _run(2, seconds=8.0)
    assert out.returncode == 0, out.stderr[-3000:]
    line = _line(out)
    assert line["correct"] is True and line["attempted"] >= 2
    assert line["checks"]["rank_gap"] == {"value": 0.0, "limit": 0.0}


def test_a_traced_run_reads_rank_0():
    out, _, _ = _run(2, trace=1)
    assert out.returncode == 0, out.stderr[-3000:]
    line = _line(out)
    assert line["correct"] is True
    per_layer = {m["name"] for m in spec.cell_spec(CELL)["per_layer"]}
    # the CPU has no device trace: the host readers read, the device ones
    # (collective_ms among them) read nothing
    assert {"eval_ms.sharded", "loop_host_ms.sharded",
            "evals_per_iter.sharded"} <= set(line["metrics"]) <= per_layer
    assert {"busy_s", "window_s"} <= set(line["device"])


def test_a_rank_gradient_left_out_of_the_sum_reads_not_correct():
    out, _, _ = _run(2, fault="drop_gradient:1")
    assert out.returncode == 0, out.stderr[-3000:]
    line = _line(out)
    assert line["correct"] is False
    assert (line["checks"]["grad_gap"]["value"]
            > line["checks"]["grad_gap"]["limit"])


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_of_the_timed_path_on_every_rank_reads_not_correct(fault):
    out, _, _ = _run(2, fault=f"program:{fault}")
    assert out.returncode == 0, out.stderr[-3000:]
    assert _line(out)["correct"] is False, out.stderr[-3000:]


@pytest.mark.parametrize("rank", [1, 0])
def test_a_rank_killed_in_the_window_ends_every_rank(rank):
    out, took, pids = _run(2, fault=f"die:{rank}:3", seconds=4.0)
    assert out.returncode != 0
    assert not out.stdout.strip() or not out.stdout.strip().startswith("{")
    assert took < RUN_LIMIT_S and took < ranks.TIMEOUT_S
    assert pids and all(_gone(p) for p in pids)


@pytest.mark.parametrize("rank", [1, 0])
def test_a_rank_that_loaded_jax_makes_the_run_print_no_result(rank):
    out, _, pids = _run(2, fault=f"load_jax:{rank}")
    assert out.returncode == 3, out.stderr[-3000:]
    assert not out.stdout.strip()
    assert f"rank {rank}: ['jax']" in out.stderr
    assert pids and all(_gone(p) for p in pids)


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_the_reference_in_blocks_sums_to_the_whole(n):
    from benchmark.harness import inputs
    from benchmark.reference import two_transmon_gate as kind

    from . import tiny

    cfg = tiny.config(CELL, samples=4)
    raw = inputs.draw(cfg, SEED)
    x = 0.05 * np.random.default_rng(1).normal(size=(4, cfg["n_steps"]))
    J, g = kind.Reference(cfg, raw, "cpu").value_and_grad(x)
    blocks = kind.blocks(raw, n)
    held = [b for b in blocks if b is not None]
    assert len(blocks) == n and len(held) == min(n, 4)
    J_b, g_b = kind.combine(held, [kind.Reference(cfg, b, "cpu")
                                   .value_and_grad(x) for b in held])
    assert abs(J_b - J) < 1e-13
    assert np.max(np.abs(g_b - g)) < 1e-13 * np.max(np.abs(g))


def _state(J=0.5, iteration=3, solves=((4, 0.4, "ok"),)):
    rec = {"solve": 0, "iteration": iteration, "pulses": np.ones((2, 3)),
           "J_T": J, "gradient": np.arange(6.0)}
    return {"records": [rec], "solves": list(solves)}


def test_rank_gap():
    assert check.rank_gap([_state()]) == 0.0
    assert check.rank_gap([_state(), _state()]) == 0.0
    assert check.rank_gap([_state(), _state(J=0.5 + 1e-16)]) > 0.0
    assert check.rank_gap([_state(), _state(iteration=4)]) == math.inf
    assert check.rank_gap([_state(), _state(solves=())]) == math.inf
    assert check.rank_gap(
        [_state(), _state(solves=((5, 0.4, "ok"),))]) == math.inf
    assert not check.passes({"rank_gap": 1e-16}, {"rank_gap": 0.0})


def test_card_share():
    st = {"G": 128, "gs": 4, "K": 512, "d": 100}
    assert ranks.card_share(st, 1) is st
    assert ranks.card_share(st, 4) == dict(st, G=32, K=128)
    # a cell's groups divide its cards, as parallel.shard_problem cuts them
    with pytest.raises(ValueError):
        ranks.card_share(dict(st, G=2, K=8), 4)


def test_collective_ms_reads_the_nccl_kernels_per_evaluation():
    path = os.path.join(spec.BENCH_DIR, "metrics", "collective_ms.py")
    module_spec = importlib.util.spec_from_file_location("r_coll", path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)

    def x(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    ua = "user_annotation"
    events = [
        x(ua, "grape.evaluate_gradient", 0.0, 1000.0),
        x(ua, "grape.evaluate_functional", 2000.0, 1000.0),
        x("kernel", "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernel"
          "ArgsStorage<4096ul>)", 500.0, 300.0),
        x("kernel", "ncclDevKernel_AllReduce_Sum_f64_RING_LL(ncclDevKernel"
          "ArgsStorage<4096ul>)", 2500.0, 100.0),
        x("kernel", "void grape::state_scan_kernel<0, 4>(float2 const*)",
          100.0, 300.0),
        x("cpu_op", "nccl:all_reduce", 480.0, 50.0),
        x("cpu_op", "end", 3900.0, 100.0),
    ]
    ctx = SimpleNamespace(recorder=SimpleNamespace(events=events))
    assert module.read(ctx) == pytest.approx(0.2)  # 400 us over 2 evaluations
    no_nccl = [e for e in events if not e["name"].startswith("nccl")]
    assert module.read(SimpleNamespace(
        recorder=SimpleNamespace(events=no_nccl))) is None
    assert module.read(SimpleNamespace(recorder=None)) is None
