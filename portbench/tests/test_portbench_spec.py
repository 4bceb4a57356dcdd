"""Cells, configurations, traffic, limits and metrics are found by name
from data, and ``BENCHMARK.json`` keeps its keys, names and bounds."""

from __future__ import annotations

import json
import re

import pytest

from portbench import spec
from portbench.tests.conftest import HELD, held_cell

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CHECKS = {"fleet_window": {"ratio_gap", "model_gap"},
          "refit": {"loss_gap", "change_gap", "timed_change_gap",
                    "unmoved_leaves"}}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("work", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_is_found_by_name(work):
    cell = spec.cell(work["name"])
    assert cell.chips == work["chips"] == 1
    driver = spec.driver(cell.traffic["driver"])
    assert callable(driver.setup)
    assert set(cell.limits) == CHECKS[cell.traffic["driver"]]
    assert all(v >= 0 for v in cell.limits.values())
    assert "setup_s" in {m["name"] for m in cell.end_to_end}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    with pytest.raises(KeyError):
        spec.cell(work["name"] + "-missing")


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_file(conf):
    assert conf["file"].startswith("portbench/configs/")
    with open(spec.ROOT / conf["file"]) as f:
        data = json.load(f)
    assert data["name"] == conf["name"]
    assert data["source"] == conf["source"]
    assert data["reduced"] == conf["reduced"]
    assert all(k in data for k in conf["reduced"])
    assert {"assumed", "deployment"} <= set(data)


@pytest.mark.parametrize(
    "metric", BENCH["end_to_end"] + BENCH["per_layer"],
    ids=lambda m: m["name"])
def test_metric_has_a_reader(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(spec.metric(metric["name"]).read)
    if "moves" in metric:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}


def test_names_and_lengths():
    names = [w["name"] for w in BENCH["workloads"]]
    names += [c["name"] for c in BENCH["configs"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    assert all(NAME.match(n) for n in names)
    for entry in BENCH["workloads"] + BENCH["configs"]:
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_no_end_to_end_metric_lists_cells():
    """An end-to-end metric is read in every cell; its reader returns
    ``None`` where the cell's driver keeps no count it reads."""
    assert all("workloads" not in m for m in BENCH["end_to_end"])


def test_mlp_refit_reports_its_rate_and_setup():
    names = {m["name"] for m in spec.cell("mlp-refit").end_to_end}
    assert {"train_samples_per_s", "setup_s"} <= names


def test_per_layer_lists_cells_that_report_its_end_to_end_metric():
    for m in BENCH["per_layer"]:
        for name in m.get("workloads", []):
            assert m["moves"] in {x["name"]
                                  for x in spec.cell(name).end_to_end}


@pytest.mark.parametrize("name", sorted(HELD))
def test_a_held_cell_is_found_from_its_files(name):
    """A cell left out of ``BENCHMARK.json`` keeps its configuration,
    traffic, limits, driver and metric readers in place, and is not in
    ``BENCHMARK.json``."""
    cell = held_cell(name)
    assert name not in {w["name"] for w in BENCH["workloads"]}
    assert set(cell.limits) == CHECKS[cell.traffic["driver"]]
    assert callable(spec.driver(cell.traffic["driver"]).setup)
    assert {"assumed", "deployment", "source"} <= set(cell.config)
    for metric in cell.end_to_end + cell.per_layer:
        assert callable(spec.metric(metric["name"]).read)
