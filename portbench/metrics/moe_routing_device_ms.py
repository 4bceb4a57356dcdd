"""Device time a step of the mixture's own forward work beyond its
experts: the kernels launched inside the program's ``moe.gate`` (the
router's logits and softmax) and ``moe.combine`` (the gate-weighted sum
over experts, the clamp and the mask) spans, from the profiler. Their
backward runs under ``train.backward``."""

RANGES = ("moe.gate", "moe.combine")


def read(r):
    steps = r.window.counts.get("steps")
    if r.trace is None or not steps or not all(
            r.trace.count_host(name) for name in RANGES):
        return None
    return sum(r.trace.device_s_under(name) for name in RANGES) / steps * 1e3
