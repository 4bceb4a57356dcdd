"""Device time a step of the kernels AdamW launches (inside
``torch.optim``'s own ``Optimizer.step#AdamW.step`` range), from the
profiler."""

RANGE = "Optimizer.step#AdamW.step"


def read(r):
    steps = r.window.counts.get("steps")
    if r.trace is None or not steps or not r.trace.count_host(RANGE):
        return None
    return r.trace.device_s_under(RANGE) / steps * 1e3
