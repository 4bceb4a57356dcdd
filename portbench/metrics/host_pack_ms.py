"""Host time a window inside the program's ``fleet.pack`` spans
(``put_blocks``' pack of each node block into its byte buffer), from
the profiler's ranges on the window's thread."""

RANGE = "fleet.pack"


def read(r):
    windows = r.window.counts.get("windows")
    if r.trace is None or not windows or not r.trace.count_host(RANGE):
        return None
    us = sum(o.end - o.start for o in r.trace.host if o.name == RANGE)
    return us * 1e-3 / windows
