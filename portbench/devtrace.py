"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over the
measured window, read back from its Chrome trace.

``DeviceTrace`` keeps the device's operations (kernels, copies, sets),
the host's ranges on the window's thread (the harness's spans, the
optimizer's ranges and PyTorch's operators) and the runtime's launch
calls, all on the profiler's clock in µs, clipped to the window: the
``portbench.window`` range around the measured loop.
"""

from __future__ import annotations

import bisect
import json
import os
import shutil
import tempfile
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Iterable, TypeVar

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op")
WINDOW = "portbench.window"
TOP = 10

T = TypeVar("T")


@dataclass(frozen=True)
class Op:
    name: str
    cat: str
    start: float  # µs
    end: float
    correlation: int | None = None
    tid: object = None


@dataclass
class DeviceTrace:
    start: float
    end: float
    device: list[Op]
    host: list[Op]
    launches: list[Op]

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def busy_intervals(self) -> list[tuple[float, float]]:
        spans = sorted((max(o.start, self.start), min(o.end, self.end))
                       for o in self.device)
        merged: list[list[float]] = []
        for lo, hi in spans:
            if hi <= lo:
                continue
            if merged and lo <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], hi)
            else:
                merged.append([lo, hi])
        return [(lo, hi) for lo, hi in merged]

    @property
    def busy_s(self) -> float:
        return sum(hi - lo for lo, hi in self.busy_intervals()) * 1e-6

    def device_s(self, keep: Callable[[Op], bool]) -> float:
        """Seconds of the device operations ``keep`` selects."""
        return sum(o.end - o.start for o in self.device if keep(o)) * 1e-6

    def durations(self, keep: Callable[[Op], bool]) -> list[float]:
        return [(o.end - o.start) * 1e-6 for o in self.device if keep(o)]

    def device_s_under(self, host_name: str) -> float:
        """Seconds of the device operations launched inside a host range
        named ``host_name`` (by the launch call's correlation id)."""
        ranges = sorted((o.start, o.end) for o in self.host
                        if o.name == host_name)
        starts = [lo for lo, _ in ranges]

        def under(t: float) -> bool:
            i = bisect.bisect_right(starts, t) - 1
            return i >= 0 and t <= ranges[i][1]

        ids = {o.correlation for o in self.launches
               if o.correlation is not None and under(o.start)}
        return self.device_s(lambda o: o.correlation in ids)

    def count_host(self, name: str) -> int:
        return sum(1 for o in self.host if o.name == name)

    def breakdown(self) -> dict[str, list[list]]:
        """The device operations that took most time, and the longest
        idle gaps by what the host was doing (the innermost harness span
        and PyTorch operator around the gap's middle)."""
        by_op: dict[str, float] = defaultdict(float)
        for o in self.device:
            by_op[o.name] += (o.end - o.start) * 1e-6
        idle = []
        cursor = self.start
        for lo, hi in self.busy_intervals() + [(self.end, self.end)]:
            if lo > cursor:
                idle.append(((cursor + lo) / 2, (lo - cursor) * 1e-6))
            cursor = max(cursor, hi)
        gaps: dict[str, float] = defaultdict(float)
        for (_, seconds), name in zip(idle, self._host_at(
                [t for t, _ in idle])):
            gaps[name] += seconds
        return {"device_ops": _top(by_op), "idle_gaps": _top(gaps)}

    def _host_at(self, times: list[float]) -> list[str]:
        """For each time (ascending): the innermost harness span and
        PyTorch operator open on the window's thread, joined by "/"
        ("host" where none is). The thread's ranges nest, so one sweep
        with a stack of the open ranges finds them."""
        ranges = sorted((o for o in self.host if o.name != WINDOW),
                        key=lambda o: (o.start, -o.end))
        stack: list[Op] = []
        out, i = [], 0
        for t in times:
            while i < len(ranges) and ranges[i].start <= t:
                while stack and stack[-1].end < ranges[i].start:
                    stack.pop()
                stack.append(ranges[i])
                i += 1
            while stack and stack[-1].end < t:
                stack.pop()
            names = []
            for cat in HOST_CATS:
                names += [o.name for o in reversed(stack)
                          if o.cat == cat and o.end >= t][:1]
            out.append("/".join(names) if names else "host")
        return out


def _top(totals: dict[str, float]) -> list[list]:
    items = sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]
    return [[name[:96], seconds] for name, seconds in items]


def _ops(events: Iterable[dict], cats: tuple[str, ...]) -> list[Op]:
    out = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in cats:
            continue
        start = float(e["ts"])
        corr = (e.get("args") or {}).get("correlation")
        out.append(Op(e["name"], e["cat"], start, start + float(e["dur"]),
                      corr, e.get("tid")))
    return out


def parse(events: list[dict]) -> DeviceTrace:
    """A Chrome trace's events → the window's ``DeviceTrace``."""
    windows = [e for e in events
               if e.get("ph") == "X" and e.get("name") == WINDOW]
    if not windows:
        raise ValueError(f"the trace holds no {WINDOW!r} range")
    w = windows[0]
    start, end = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    tid = w.get("tid")

    def inside(o: Op) -> bool:
        return o.end > start and o.start < end

    return DeviceTrace(
        start=start, end=end,
        device=[o for o in _ops(events, DEVICE_CATS) if inside(o)],
        host=[o for o in _ops(events, HOST_CATS)
              if o.tid == tid and inside(o)],
        launches=[o for o in _ops(events, ("cuda_runtime", "cuda_driver"))
                  if inside(o)])


def traced(fn: Callable[[], T]) -> tuple[T, DeviceTrace]:
    """Run ``fn`` (the measured window) under ``torch.profiler`` inside a
    ``portbench.window`` range → (its result, the window's trace). The
    profiler starts before the range, so its start-up is not traced;
    the Chrome trace goes to a temporary directory and is removed."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        with record_function(WINDOW):
            result = fn()
        torch.cuda.synchronize()
    finally:
        prof.stop()
    tmp = tempfile.mkdtemp(prefix="portbench-trace-")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return result, parse(events)
