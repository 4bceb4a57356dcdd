"""Device time a step of the kernels the temporal estimator's forward
launches for attention (inside the program's ``temporal.attention``
span: the last tick's query, the scores, the mask and softmax, and
probs·V), from the profiler. Their backward runs under
``train.backward``."""

RANGE = "temporal.attention"


def read(r):
    steps = r.window.counts.get("steps")
    if r.trace is None or not steps or not r.trace.count_host(RANGE):
        return None
    return r.trace.device_s_under(RANGE) / steps * 1e3
