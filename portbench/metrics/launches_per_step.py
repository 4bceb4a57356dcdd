"""Kernel launches a step: the profiler's launch calls (a name that
holds ``Launch``: ``cudaLaunchKernel``, ``cuLaunchKernel`` and kin) that
start inside the program's ``train.step`` span, on any thread (autograd
launches the backward from its own), over the steps."""

import bisect

RANGE = "train.step"


def read(r):
    steps = r.window.counts.get("steps")
    if r.trace is None or not steps:
        return None
    ranges = sorted((o.start, o.end) for o in r.trace.host
                    if o.name == RANGE)
    if not ranges:
        return None
    starts = [lo for lo, _ in ranges]

    def inside(t: float) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= ranges[i][1]

    return sum(1 for o in r.trace.launches
               if "Launch" in o.name and inside(o.start)) / steps
