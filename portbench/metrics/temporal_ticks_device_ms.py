"""Device time a step of the kernels the temporal estimator's forward
launches at every tick (inside the program's ``temporal.ticks`` span:
the in-projection, positions, LN1 and the K and V projections), from
the profiler. Their backward runs under ``train.backward``."""

RANGE = "temporal.ticks"


def read(r):
    steps = r.window.counts.get("steps")
    if r.trace is None or not steps or not r.trace.count_host(RANGE):
        return None
    return r.trace.device_s_under(RANGE) / steps * 1e3
