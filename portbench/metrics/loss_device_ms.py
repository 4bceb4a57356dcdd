"""Device time a step of the kernels the loss launches (inside the
program's ``train.loss`` span: ``masked_mse``), from the profiler."""

RANGE = "train.loss"


def read(r):
    steps = r.window.counts.get("steps")
    if r.trace is None or not steps or not r.trace.count_host(RANGE):
        return None
    return r.trace.device_s_under(RANGE) / steps * 1e3
