"""Labelled rows × completed steps over the whole window's host-clock
seconds."""


def read(r):
    done = r.window.counts.get("samples")
    return None if done is None else done / r.window.seconds
