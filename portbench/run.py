"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. Set-up (``setup_s``, counted from the
process's start) makes the cell's inputs and weights from the seed,
loads the port's kernels (``kepler_tpu_torch/_build/``, built there on a
checkout's first run) and warms up the cell's own shapes; then the
window runs for ``--seconds``; then the comparison with the plain
reference decides ``correct``. The last line on standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, on a traced run ``breakdown``, and last ``checks``: each
number compared with its limit), and the last lines on standard error
give the same checks. Without CUDA, with fewer cards than the cell asks
for, or with JAX or the JAX package loaded once the window has closed,
it prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up counts from here, imports included

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
    sys.path[0] = str(HERE.parent)  # import as the ``portbench`` package

# names whose top-level module must not be loaded by the run
FENCED = ("jax", "jaxlib", "flax", "kepler_tpu")


def parse_args(argv: list[str] | None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fenced_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot, whole)
    is fenced."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FENCED)


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t0: float) -> tuple[dict, list]:
    """Set-up, window and comparison of ``cell`` on ``device`` → (the
    result line without ``checks``, the checks)."""
    import torch

    from portbench import devtrace, spec
    from portbench.harness import Reading, Spans

    session = spec.driver(cell.traffic["driver"]).setup(
        cell.config, cell.traffic, seed, device, Spans(trace))
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    if trace:
        window, dtrace = devtrace.traced(lambda: session.run(seconds))
    else:
        window, dtrace = session.run(seconds), None
    info = {"platform": "gpu" if cuda else device.type,
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                  if cuda else 0)}
    checks = session.check(cell.limits)
    reading = Reading(cell.config, cell.traffic, setup_s, window, dtrace)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.metric(m["name"]).read(reading)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": window.failed == 0 and all(c.ok for c in checks),
           "attempted": window.attempted, "failed": window.failed,
           "metrics": metrics, "device": info}
    if dtrace is not None:
        info["busy_s"] = dtrace.busy_s
        info["window_s"] = dtrace.window_s
        out["breakdown"] = dtrace.breakdown()
    return out, checks


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    from portbench import spec

    try:
        cell = spec.cell(args.workload)
    except KeyError:
        print(f"portbench: no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("portbench: CUDA is not available", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    out, checks = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), T0)
    leaked = fenced_modules()
    if leaked:
        print(f"portbench: the run loaded {', '.join(leaked)}",
              file=sys.stderr)
        return 3
    # a non-finite reading (a fault) goes out as null: JSON has no inf
    out["checks"] = {c.name: {"value": c.value if math.isfinite(c.value)
                              else None, "limit": c.limit}
                     for c in checks}
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
