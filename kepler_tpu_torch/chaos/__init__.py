"""kepchaos: randomized fault-schedule conductor over the port's fleet.

The counterpart of ``kepler_tpu.chaos``: kepchaos generates randomized,
time-phased fault schedules over the full composed surface — fault-site
injections, replica kill/restart, membership join/leave/autoscale ops —
drives them against an in-process fleet of the port's real Aggregators
(on the card unless ``ChaosConfig(device="cpu")``) and wire-faithful
agents, and judges six global invariants on every run. Runs are keyed
by ``(seed, schedule index)`` and replay bit-identically; failing
schedules shrink to a minimal fault subsequence via delta debugging.

Exports resolve lazily (PEP 562): ``python -m kepler_tpu_torch.chaos``
imports this module before ``__main__`` parses its arguments, so
nothing here may import the fleet (and thus torch) at module import
time.

See docs/developer/resilience.md "Randomized chaos" and run
``python -m kepler_tpu_torch.chaos --help``.
"""

from typing import Any

_EXPORTS = {
    "ChaosAgent": "kepler_tpu_torch.chaos.harness",
    "ChaosConfig": "kepler_tpu_torch.chaos.harness",
    "ChaosEvent": "kepler_tpu_torch.chaos.schedule",
    "ChaosFleet": "kepler_tpu_torch.chaos.harness",
    "ChaosReport": "kepler_tpu_torch.chaos.conductor",
    "EXCLUDED_SITES": "kepler_tpu_torch.chaos.schedule",
    "FAULT_POOL": "kepler_tpu_torch.chaos.schedule",
    "MembershipView": "kepler_tpu_torch.chaos.invariants",
    "RowRecord": "kepler_tpu_torch.chaos.invariants",
    "RunRecord": "kepler_tpu_torch.chaos.invariants",
    "RunResult": "kepler_tpu_torch.chaos.conductor",
    "Schedule": "kepler_tpu_torch.chaos.schedule",
    "Trace": "kepler_tpu_torch.chaos.trace",
    "Violation": "kepler_tpu_torch.chaos.invariants",
    "WindowRecord": "kepler_tpu_torch.chaos.invariants",
    "check_all": "kepler_tpu_torch.chaos.invariants",
    "compile_fault_specs": "kepler_tpu_torch.chaos.schedule",
    "ddmin": "kepler_tpu_torch.chaos.schedule",
    "generate": "kepler_tpu_torch.chaos.schedule",
    "repro_command": "kepler_tpu_torch.chaos.conductor",
    "run_many": "kepler_tpu_torch.chaos.conductor",
    "run_schedule": "kepler_tpu_torch.chaos.conductor",
    "shrink": "kepler_tpu_torch.chaos.conductor",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str) -> Any:
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib

    return getattr(importlib.import_module(module), name)
