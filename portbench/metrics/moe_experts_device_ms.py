"""Device time a step of the kernels the mixture's experts launch in the
forward (inside the program's ``moe.experts`` span: both products of
every expert, the bias and GELU passes and the skip path), from the
profiler. Their backward runs under ``train.backward``."""

RANGE = "moe.experts"


def read(r):
    steps = r.window.counts.get("steps")
    if r.trace is None or not steps or not r.trace.count_host(RANGE):
        return None
    return r.trace.device_s_under(RANGE) / steps * 1e3
