"""Device time a step of the kernels the backward launches (inside the
program's ``train.backward`` span: ``loss.backward()``, remat's
recomputed forward included), from the profiler. Autograd launches them
from its own thread; a launch is matched to the span by its time, on
any thread."""

RANGE = "train.backward"


def read(r):
    steps = r.window.counts.get("steps")
    if r.trace is None or not steps or not r.trace.count_host(RANGE):
        return None
    return r.trace.device_s_under(RANGE) / steps * 1e3
