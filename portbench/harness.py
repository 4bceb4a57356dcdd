"""What every driver and metric reader shares: spans, a run's reading,
the checks that decide ``correct``, and a driver's interface.

A driver (``drivers/<name>.py``, named by a traffic file's ``driver``)
has ``setup(config, traffic, seed, device, spans) → session``. A session
has ``run(seconds) → Window`` (the measured window: closed loop, nothing
compiles there) and ``check(limits) → list[Check]`` (after the window:
frees the program's state, runs the reference, compares).
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field
from typing import Any, ContextManager, Mapping


class Spans:
    """The harness's own spans around its calls into the port: profiler
    ranges when the run is traced, nothing otherwise."""

    def __init__(self, on: bool) -> None:
        self.on = on

    def __call__(self, name: str) -> ContextManager:
        if not self.on:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)


@dataclass
class Window:
    """The measured window: its host-clock length, what it completed
    (``counts``: windows, workloads, steps, samples …) and per-item
    samples (``samples``: e.g. each window's latency in ms)."""

    seconds: float
    counts: dict[str, float]
    attempted: int
    failed: int = 0
    samples: dict[str, list[float]] = field(default_factory=dict)


@dataclass(frozen=True)
class Check:
    """One number the comparison reads, and its limit (a number at or
    under the limit passes; a number that is not finite fails)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Reading:
    """Everything a metric reader may read of one run."""

    config: Mapping[str, Any]
    traffic: Mapping[str, Any]
    setup_s: float
    window: Window
    trace: Any = None  # trace.DeviceTrace on a --trace 1 run


def max_rel_gap(got: Any, want: Any) -> float:
    """max |got − want| over max |want| (numpy arrays of one shape): 0
    when both are all zero, inf when either holds a non-finite value or
    only ``got`` is non-zero."""
    import numpy as np

    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.size == 0:
        return 0.0
    if not (np.isfinite(got).all() and np.isfinite(want).all()):
        return math.inf
    diff = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    if scale == 0.0:
        return 0.0 if diff == 0.0 else math.inf
    return diff / scale
