"""Device time a window of every kernel but B1 (the estimator and the
glue around it; copies and sets not counted), from the profiler."""

B1 = "outer_product_kernel"


def read(r):
    windows = r.window.counts.get("windows")
    if r.trace is None or not windows:
        return None
    s = r.trace.device_s(lambda o: o.cat == "kernel" and B1 not in o.name)
    return s / windows * 1e3
