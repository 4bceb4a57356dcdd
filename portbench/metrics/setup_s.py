"""Set-up seconds on the host clock: from the process's start to the
window's, imports, data, weights, the kernels' build or load and the
warm-up included."""


def read(r):
    return r.setup_s
