"""Faults planted under a cell's timed path, to show that ``correct``
catches them: each is a context manager that wraps the port's entry the
driver calls, for as long as it is open (set-up included).

fleet_window (``run_fleet_attribution``): ``stale`` (every window
returns the first window's results: a step that leaves its state
unchanged), ``half`` (the second half of the node rows left out, as
zeros), ``altered`` (one workload's watts on one model node off by 1%
of the largest).

refit (``cmd.train.build_trainer``'s ``step_fn``): ``stale`` (the step
puts the params back as they were), ``half`` (the step sees the first
half of the rows only, its mean over those), ``altered`` (the loss it
returns 1% high).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Iterator

import torch

WINDOW_FAULTS = ("stale", "half", "altered")
REFIT_FAULTS = ("stale", "half", "altered")


@contextlib.contextmanager
def _patched(module: Any, name: str, wrap: Callable) -> Iterator[None]:
    real = getattr(module, name)
    setattr(module, name, wrap(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def _window_fault(kind: str) -> Callable:
    def wrap(real: Callable) -> Callable:
        first: list = []

        def fault(r: Any, mode: torch.Tensor) -> Any:
            fields = {k: v.clone() for k, v in r._asdict().items()}
            if kind == "half":
                n = fields["workload_power_uw"].shape[0]
                for v in fields.values():
                    v[n // 2:] = 0
            elif kind == "altered":
                wp = fields["workload_power_uw"]
                node = int(torch.nonzero(mode.to(wp.device) == 1)[0, 0])
                wp[node, 0, 0] += 0.01 * wp.abs().max()
            return r._replace(**fields)

        def run(program, batch, params=None, feat_hist=None, t_valid=None):
            """Over a mesh the result is one per node block, in block
            order (one block here: the cell runs on one card)."""
            blocks = real(program, batch, params, feat_hist, t_valid)
            if kind == "stale":
                if not first:
                    first.append(tuple(fault(r, None) for r in blocks))
                return first[0]
            mode = torch.as_tensor(batch.mode)
            return tuple(fault(r, mode) for r in blocks)

        return run

    return wrap


def _refit_fault(kind: str) -> Callable:
    def wrap(real: Callable) -> Callable:
        def build(args, data, device):
            state, step_fn, inputs = real(args, data, device)

            def step(state, *ins):
                if kind == "half":
                    rows = ins[1].shape[0] // 2
                    ins = tuple(x[:rows] for x in ins)
                before = {k: v.detach().clone()
                          for k, v in state.params.items()}
                state, loss = step_fn(state, *ins)
                if kind == "stale":
                    with torch.no_grad():
                        for k, v in state.params.items():
                            v.copy_(before[k])
                elif kind == "altered":
                    loss = loss * 1.01
                return state, loss

            return state, step, inputs

        return build

    return wrap


def planted(driver: str, kind: str) -> contextlib.AbstractContextManager:
    """The fault ``kind`` planted under ``driver``'s timed path."""
    if driver == "fleet_window":
        from kepler_tpu_torch.parallel import aggregator_core

        return _patched(aggregator_core, "run_fleet_attribution",
                        _window_fault(kind))
    if driver == "refit":
        from kepler_tpu_torch.cmd import train

        return _patched(train, "build_trainer", _refit_fault(kind))
    raise ValueError(f"no faults for driver {driver!r}")
