"""The 95th percentile of the windows' times from the start of a
window's dispatch to its results on the host (host clock; at least 20
windows)."""

import statistics


def read(r):
    ms = r.window.samples.get("window_ms", [])
    if len(ms) < 20:
        return None
    return statistics.quantiles(ms, n=20)[-1]
