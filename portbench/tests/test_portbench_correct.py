"""``correct`` comes out true for the program and false for its control
and for every fault planted under the timed path.

Each test skips the harness's look for a card and drives the rest of a
run (``run.run_cell``: set-up, window, comparison) on the CPU at a size
a test holds, with the cells' own limits.
"""

from __future__ import annotations

import time

import pytest
import torch

from portbench import faults, spec
from portbench.harness import Check, Spans
from portbench.run import run_cell

CPU = torch.device("cpu")
CELLS = ("temporal-window", "mlp-refit")
FAULTS = {"temporal-window": faults.WINDOW_FAULTS,
          "mlp-refit": faults.REFIT_FAULTS}


def _run(cell, seed: int = 2**31 + 7):
    out, checks = run_cell(cell, seed, 0.3, False, CPU, time.perf_counter())
    return out, checks


@pytest.mark.parametrize("name", CELLS)
def test_the_program_is_correct(tiny, name):
    out, checks = _run(tiny(name))
    assert out["correct"], checks
    assert out["attempted"] > 0 and out["failed"] == 0
    assert {"setup_s"} < set(out["metrics"])


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not(tiny, name):
    """The reference one precision below the configuration's, in the
    program's place, fails at least one of the cell's numbers."""
    cell = tiny(name)
    driver = spec.driver(cell.traffic["driver"])
    for seed in (1, 2, 3):
        session = driver.setup(cell.config, cell.traffic, seed, CPU,
                               Spans(False))
        session.run(0.1)
        control = session.control_gaps()
        checks = [Check(k, control[k], limit)
                  for k, limit in cell.limits.items()]
        assert not all(c.ok for c in checks), (seed, control)


@pytest.mark.parametrize("name,fault",
                         [(n, f) for n in CELLS for f in FAULTS[n]])
def test_a_planted_fault_is_not(tiny, name, fault):
    cell = tiny(name)
    with faults.planted(cell.traffic["driver"], fault):
        out, checks = _run(cell)
    assert not out["correct"], checks


def test_a_window_that_leaves_the_state_unmoved_is_not(tiny):
    """A refit whose checked steps and step after the window are sound,
    but whose window steps leave the params as they were."""
    cell = tiny("mlp-refit")
    session = spec.driver("refit").setup(cell.config, cell.traffic, 4, CPU,
                                         Spans(False))
    sound = session.step_fn

    def stale(state, *inputs):
        before = {k: v.detach().clone() for k, v in state.params.items()}
        state, loss = sound(state, *inputs)
        with torch.no_grad():
            for k, v in state.params.items():
                v.copy_(before[k])
        return state, loss

    session.step_fn = stale
    session.run(0.1)
    session.step_fn = sound
    got = session.program_readings()
    assert got["unmoved_leaves"] > cell.limits["unmoved_leaves"], got
