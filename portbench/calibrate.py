"""Readings that set a cell's limits, on the card, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds 2 [--control] [--faults stale,half]

For each seed: the cell's set-up, a short window and the comparison
(the program's readings); with ``--control`` the control's readings on
the same sampled work (the reference one precision below the
configuration's in the program's place); with ``--faults`` the readings
of each fault of ``faults.py`` planted under the timed path, on the
first three seeds. One JSON line per reading on standard output; a
refit's line adds the readings that are not compared (``look``: each
checked step's loss gap, and the first gradient's gap by the worst leaf,
from AdamW's ``exp_avg``). The benchmark's runs never run this.
"""

from __future__ import annotations

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
    sys.path[0] = str(HERE.parent)

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

FAULT_SEEDS = 3


def look(session) -> dict:
    """A refit's readings that are not compared."""
    from portbench.drivers.refit import leaf_gap, norms

    ref = session.ref
    return {
        "loss_gap_by_step": [abs(a - b) / abs(b) if b else abs(a - b)
                             for a, b in zip(session.losses, ref.losses)],
        "grad_gap": leaf_gap(norms(session.first_grad),
                             norms(ref.grads[0])),
    }


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", default="")
    args = p.parse_args(argv)

    import torch

    from portbench import faults, spec
    from portbench.harness import Spans

    if not torch.cuda.is_available():
        print("calibrate: CUDA is not available", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    dev = torch.device("cuda", 0)
    torch.cuda.init()
    torch.set_num_threads(2)
    driver_name = cell.traffic["driver"]
    driver = spec.driver(driver_name)
    seeds = [int(s) for s in args.seeds.split(",")]
    kinds = [k for k in args.faults.split(",") if k]

    def one(seed: int, fault: str = "") -> dict:
        plant = (faults.planted(driver_name, fault) if fault
                 else contextlib.nullcontext())
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with plant:
            session = driver.setup(cell.config, cell.traffic, seed, dev,
                                   Spans(False))
            torch.cuda.synchronize(dev)
            setup_s = time.perf_counter() - t0
            window = session.run(args.seconds)
        peak = torch.cuda.max_memory_allocated(dev)
        row = {"workload": cell.name, "seed": seed, "fault": fault or None,
               "setup_s": setup_s, "window_s": window.seconds,
               "counts": window.counts, "memory_peak_bytes": peak,
               "program": session.program_readings()}
        if driver_name == "refit":
            row["look"] = look(session)
        if args.control and not fault:
            row["control"] = session.control_gaps()
        del session
        torch.cuda.empty_cache()
        return row

    for seed in seeds:
        print(json.dumps(one(seed)), flush=True)
    for kind in kinds:
        for seed in seeds[:FAULT_SEEDS]:
            print(json.dumps(one(seed, kind)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
