"""Fixtures of the benchmark's own tests: its cells at a size the CPU
holds, and the card for the tests marked ``cuda``.

Run here with ``python -m pytest portbench/tests``; on the card with
``python -m pytest -m cuda portbench/tests``.
"""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


# cells whose files are in place but that ``BENCHMARK.json`` does not
# hold yet (PERF.md, Open questions): configuration, traffic, and the
# end-to-end and per-layer metrics (name, unit) each would report
HELD = {"temporal-window": (
    "fleet-1k-temporal", "closed-ring",
    [("window_workloads_per_s", "workloads/s"), ("setup_s", "s")],
    [("window_ms_p95", "ms"), ("h2d_ms", "ms"), ("estimator_device_ms", "ms"),
     ("b1_roofline", "%"), ("window_mfu_pct", "%"),
     ("device_idle_pct.window", "%")])}


def held_cell(name: str):
    """A held cell, found from its files as ``spec.cell`` finds a cell
    of ``BENCHMARK.json``."""
    import json

    from portbench import spec

    config, traffic, e2e, per_layer = HELD[name]

    def load(*parts: str) -> dict:
        with open(spec.HERE.joinpath(*parts)) as f:
            return json.load(f)

    def metrics(pairs: list) -> list[dict]:
        return [{"name": n, "unit": u} for n, u in pairs]

    return spec.Cell(name, 1, load("configs", f"{config}.json"),
                     load("traffic", f"{traffic}.json"),
                     load("limits", f"{name}.json"), metrics(e2e),
                     metrics(per_layer))


def tiny_cell(name: str):
    """Cell ``name`` (of ``BENCHMARK.json``, or held) cut to a size the
    CPU runs in a second: 8 nodes × 5 pods (8 slots), 4 ticks of
    history, d_model 16 for the temporal estimator (the MLP keeps the
    width ``cmd.train`` builds), 3 dumped windows, 2 new pods a node."""
    from portbench import spec

    cell = held_cell(name) if name in HELD else spec.cell(name)
    config = copy.deepcopy(cell.config)
    config.update(nodes=8, pods_per_node=5, workload_bucket=8)
    if "history_window" in config:
        config["history_window"] = 4
    if "dump_windows" in config:
        config["dump_windows"] = 3
    if "d_model" in config["estimator"]:
        config["estimator"].update(d_model=16, t_max=8)
    traffic = dict(cell.traffic)
    if "new_pods_per_node" in traffic:
        traffic["new_pods_per_node"] = 2
    return spec.Cell(cell.name, cell.chips, config, traffic, cell.limits,
                     cell.end_to_end, cell.per_layer)


@pytest.fixture
def tiny():
    return tiny_cell


@pytest.fixture
def cuda_device():
    """The card; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda", 0)
