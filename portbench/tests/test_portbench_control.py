"""What the check has to catch, at a size a test run holds, on the CPU.

The control: the reference in the next precision below the configuration's
(bfloat16 for the half-cheetah's elementwise float32) in the program's place, on the rows and iterations a
run compares: the limits set from the chip's readings fail it here too.

The faults, planted under the timed path while the rest of a run (the
harness's dry path, its look for a card skipped) goes on as usual: a step
that returns its state unchanged; half of the batch left out, the mean
taken over the rest; an answer altered where it is produced. (The cells run
on one card: there is no exchange between cards to leave out.)

    python -m pytest portbench/tests -p no:randomly -n 0
"""
import time

import pytest
import torch

from portbench.harness import bench, check, spec

SMALL = {"cheetah.bptt": dict(batch=6, steps=8, check_rows=6),
         "cheetah.rollout": dict(batch=6, steps=8, check_rows=6)}
COMMON = dict(tape_pool=2, warmup_iterations=1, check_iterations=1, trace_iterations=1)
CELLS = list(SMALL)


def _run(cell):
    return bench.run(cell, 2**31 + 101, 0.3, False, time.perf_counter(), device="cpu",
                     traffic={**COMMON, **SMALL[cell]}, chip_check=False)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    code, result = _run(cell)
    assert code == 0 and result["correct"], result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    c = spec.load_cell(cell)
    c.traffic.update({**COMMON, **SMALL[cell], "steps": max(SMALL[cell]["steps"], 20)})
    driver = c.driver().Driver(c, 7, "cpu")
    driver.plan_check(1, 0)
    driver.iterate(0)
    driver.release()
    ok, shown = check.judge(driver.check(control=c.config["control"]), c.limits)
    assert not ok, shown


def _plant(monkeypatch, wrap):
    """Replace the program's rollout (the entry the window drives) by
    wrap(real rollout, model, state, taus)."""
    import diffdart_tpu_torch.sim.fast as F

    real = F.rollout_fast
    monkeypatch.setattr(F, "rollout_fast", lambda model, state, taus: wrap(real, model, state, taus))


def _state(q, v):
    from diffdart_tpu_torch.dynamics.model import State

    return State(q=q, v=v)


def _unchanged(real, model, state, taus):
    """Every step returns its state unchanged (a graph to the tape is kept)."""
    zero = 0 * taus.sum(dim=(0, 2))[:, None]
    return _state(state.q + zero, state.v + zero)


def _half_batch(real, model, state, taus):
    """The first half of the batch stepped, the mean taken over it (its
    gradients doubled); the second half left out, at its initial state."""
    h = state.q.shape[0] // 2
    f = real(model, _state(state.q[:h], state.v[:h]), taus[:, :h])
    q = f.q.detach() + 2 * (f.q - f.q.detach())
    v = f.v.detach() + 2 * (f.v - f.v.detach())
    return _state(torch.cat([q, state.q[h:]]), torch.cat([v, state.v[h:]]))


def _altered(real, model, state, taus):
    """Each answer altered where the rollout produces it: 1 cm on the root's
    second coordinate."""
    f = real(model, state, taus)
    return _state(f.q + 1e-2 * (torch.arange(f.q.shape[1]) == 1), f.v)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered],
                         ids=["state_unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_fails(monkeypatch, cell, fault):
    _plant(monkeypatch, fault)
    code, result = _run(cell)
    assert code == 0 and not result["correct"], result["checks"]
