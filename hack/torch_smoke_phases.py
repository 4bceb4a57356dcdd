"""Time the phases of any tree's ``chip_smoke.py`` on the card.

    python3 hack/torch_smoke_phases.py TREE [--phases a,b]

imports ``TREE/chip_smoke.py``, wraps each of its ``main_*`` and
``kernel_*`` functions (and ``sharded_phases``) with a wall-clock timer
that counts the outermost call only, runs its ``main()`` with the
remaining arguments and prints one JSON line, ``{"function_seconds":
{...}, "rc": ..., "seconds": ...}``, after the script's own output. For
trees whose script predates its ``phase_seconds`` (the ``total`` line):
run the old tree through this and the new one as it is, in one call, to
compare where the script's time goes.
"""

import json
import os
import sys
import time


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs

    times: dict = {}
    depth = [0]

    def wrap(name, fn):
        def timed(*a, **k):
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                depth[0] -= 1
                if depth[0] == 0:
                    times[name] = (times.get(name, 0.0)
                                   + time.perf_counter() - t0)
        return timed

    for name in dir(cs):
        if (name.startswith(("main_", "kernel_"))
                or name == "sharded_phases") and callable(getattr(cs, name)):
            setattr(cs, name, wrap(name, getattr(cs, name)))
    t0 = time.perf_counter()
    rc = cs.main(sys.argv[2:])
    print(json.dumps({"function_seconds": times, "rc": rc,
                      "seconds": time.perf_counter() - t0}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
