"""Host-to-device copy time on the device a window (profiler)."""


def read(r):
    windows = r.window.counts.get("windows")
    if r.trace is None or not windows:
        return None
    s = r.trace.device_s(lambda o: o.cat == "gpu_memcpy" and "HtoD" in o.name)
    return s / windows * 1e3
