"""The check fails a run whose timed path is broken underneath: a run on
the CPU at a tiny size (the harness's look for a card skipped) with one
fault planted in the program each, against the sound run.  The cells run
on one card, so there is no exchange between cards to leave out.  The
outer loop's faults are caught by following its path, which the cells
without bounds do (``path_iterations``)."""

import numpy as np
import pytest
import torch

from . import tiny


def _identity_steps(A):
    """Every step's propagator the identity: the state comes out of each
    step unchanged."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return eye.expand(A.shape).clone()


def _half_batch(monkeypatch):
    """The gradient over the first half of the trajectories alone, its
    mean taken over them: the second half's per-step gradients left out
    and the first half's doubled."""
    from grape_tpu_torch import fg

    original = fg._tau_grads_pass

    def tau_grads_pass(*args, **kwargs):
        tau_grads, ok = original(*args, **kwargs)
        h = tau_grads.shape[1] // 2
        tau_grads = tau_grads.clone()
        tau_grads[:, h:] = 0
        tau_grads[:, :h] *= 2
        return tau_grads, ok

    monkeypatch.setattr(fg, "_tau_grads_pass", tau_grads_pass)


def _altered(which):
    def plant(monkeypatch):
        from grape_tpu_torch import workspace

        original = workspace.GrapeWrk.evaluate_gradient

        def evaluate_gradient(self, x, G_out=None):
            J, G = original(self, x, G_out=G_out)
            if which == "gradient":
                i = int(np.argmax(np.abs(self.gradient)))
                self.gradient[i] *= -1.0
                if G_out is not None:
                    G_out[i] *= -1.0
                G = self.gradient.copy()
            else:
                J += 1e-2
                self.J_parts[0] += 1e-2
            return J, G

        monkeypatch.setattr(workspace.GrapeWrk, "evaluate_gradient",
                            evaluate_gradient)
    return plant


def _stale_gradient(monkeypatch):
    """The optimizer handed each evaluation's gradient one evaluation
    late (the first one on time): the evaluation itself, and what the
    solve records of it, stay right."""
    from grape_tpu_torch.optimizers import lbfgsb

    original = lbfgsb.LBFGSB.run

    def run(self, wrk, fg, callback, check_convergence):
        held = []

        def stale_fg(f, g, x):
            f = fg(f, g, x)
            fresh = g.copy()
            if held:
                g[:] = held.pop()
            held.append(fresh)
            return f

        return original(self, wrk, stale_fg, callback, check_convergence)

    monkeypatch.setattr(lbfgsb.LBFGSB, "run", run)


def _half_steps(monkeypatch):
    """Every accepted iterate moved back halfway to the one before: the
    optimizer's step returned half done."""
    from grape_tpu_torch.optimizers import lbfgsb

    original = lbfgsb.LBFGSB.run

    def run(self, wrk, fg, callback, check_convergence):
        def halved(w, iteration):
            if iteration > 0:
                w.pulsevals[:] = 0.5 * (w.pulsevals + w.pulsevals_guess)
            return callback(w, iteration)

        return original(self, wrk, fg, halved, check_convergence)

    monkeypatch.setattr(lbfgsb.LBFGSB, "run", run)


OUTER_LOOP_FAULTS = {
    "stale_gradient_handed_to_the_optimizer": _stale_gradient,
    "step_returned_half_done": _half_steps,
}

FAULTS = {
    "step_returns_state_unchanged": lambda mp: mp.setattr(
        __import__("grape_tpu_torch.fg", fromlist=["fg"]), "_expm_steps",
        _identity_steps),
    "half_the_batch_mean_over_the_rest": _half_batch,
    "gradient_altered_where_produced": _altered("gradient"),
    "J_T_altered_where_produced": _altered("J_T"),
}


@pytest.mark.parametrize("cell", ["cz.gradgen", "ensemble32.recompute"])
def test_sound_run_is_correct(cell):
    line, _ = tiny.run(cell)
    assert line["correct"] is True


@pytest.mark.parametrize("cell", ["cz.gradgen", "ensemble32.recompute"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_makes_the_run_incorrect(monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    line, lines = tiny.run(cell)
    assert line["correct"] is False, lines


@pytest.mark.parametrize("cell", ["cz.gradgen", "cz.taylor"])
@pytest.mark.parametrize("fault", sorted(OUTER_LOOP_FAULTS))
def test_outer_loop_fault_makes_the_run_incorrect(monkeypatch, cell, fault):
    OUTER_LOOP_FAULTS[fault](monkeypatch)
    line, lines = tiny.run(cell)
    assert line["correct"] is False, lines
    assert not (line["checks"]["path_J_gap"]["value"]
                <= line["checks"]["path_J_gap"]["limit"]
                and line["checks"]["path_x_gap"]["value"]
                <= line["checks"]["path_x_gap"]["limit"]), lines
