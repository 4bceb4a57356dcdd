"""Valid workloads attributed by the completed windows over the whole
window's host-clock seconds."""


def read(r):
    done = r.window.counts.get("workloads")
    return None if done is None else done / r.window.seconds
