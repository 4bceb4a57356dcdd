"""A cell of ``BENCHMARK.json`` and the files it is found by.

``BENCHMARK.json`` (at the checkout's root) names each cell's
configuration and traffic. The configuration's file is the one its
entry names; the traffic is ``traffic/<traffic>.json``; the limits of
the comparison are ``limits/<cell>.json``; a metric is read by
``metrics/<metric>.py``; a traffic file's ``driver`` is
``drivers/<driver>.py``; a refit's plain reference is the
configuration's ``model``'s ``reference/refit_<model>.py``. A new cell,
mix, family or metric is new files and new entries: nothing here
changes.

A per-layer metric lists its cells (``workloads``). An end-to-end metric
lists none: it is read in every cell, and its reader returns ``None``
where the cell's driver keeps no count it reads (``run.py`` prints only
what is not ``None``), so a new cell reports the end-to-end metrics
whose counts its driver keeps without an edit to an entry.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Any

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def load_benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def cell(name: str, bench: dict | None = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``bench`` (``BENCHMARK.json`` under ``root``
    by default); raises ``KeyError`` for a name it does not hold."""
    bench = load_benchmark(root) if bench is None else bench
    work = {w["name"]: w for w in bench["workloads"]}[name]
    conf = {c["name"]: c for c in bench["configs"]}[work["config"]]

    def here(metric: dict) -> bool:
        return name in metric.get("workloads", [name])

    return Cell(
        name=name, chips=int(work["chips"]),
        config=_json(root / conf["file"]),
        traffic=_json(HERE / "traffic" / f"{work['traffic']}.json"),
        limits=_json(HERE / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if here(m)],
        per_layer=[m for m in bench["per_layer"] if here(m)])


def driver(name: str) -> ModuleType:
    return importlib.import_module(f"portbench.drivers.{name}")


def refit_reference(model: str) -> ModuleType:
    """The plain refit of estimator family ``model``
    (``reference/refit_<model>.py``); ``FileNotFoundError``, naming that
    file, where it is not there."""
    path = HERE / "reference" / f"refit_{model}.py"
    if not path.is_file():
        raise FileNotFoundError(
            f"no plain refit for model {model!r}: {path} is not there")
    return importlib.import_module(f"portbench.reference.refit_{model}")


def metric(name: str) -> ModuleType:
    """The reader of metric ``name`` (``metrics/<name>.py``; a name may
    hold dots, so the file is loaded by its path)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '__')}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
