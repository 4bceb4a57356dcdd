"""keplint's whole-program rules (KTL111-113) on the port against the
reference.

Every fixture tree of ``tests/test_keplint_project.py`` is written twice,
once as the reference tree and once re-rooted under ``kepler_tpu_torch/``
(paths, and the fixtures' own imports so the port's call graph resolves
across its modules), and linted by each package's engine, whole-program
and per-file. The ``(path, rule_id, line, col, severity)`` lists must be
equal; the reference test's own assertions then run on them. Beside the
parity: tree scoping, the CLI's sarif/json/``--per-file`` on a
cross-module finding, and the full port tree inside the reference's
wall-clock budget.
"""

from __future__ import annotations

import json
import os
import re
import textwrap
import time

import pytest

import test_keplint_project as ref
from kepler_tpu.analysis import lint_paths as ref_lint_paths
from kepler_tpu_torch.analysis import lint_paths
from kepler_tpu_torch.analysis.__main__ import DEFAULT_TREES
from kepler_tpu_torch.analysis.__main__ import main as keplint_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reroot(rel: str) -> str:
    return re.sub(r"^kepler_tpu/", "kepler_tpu_torch/", rel)


def reroot_imports(source: str) -> str:
    """Only import lines change, so no finding's line or column moves."""
    return re.sub(r"^(\s*(?:from|import)\s+)kepler_tpu\b",
                  r"\1kepler_tpu_torch", source, flags=re.MULTILINE)


def write(root, rel, source):
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    return str(path)


def key(diags) -> list[tuple]:
    return [(d.path, d.rule_id, d.line, d.col, d.severity) for d in diags]


@pytest.fixture()
def plint(tmp_path):
    """The reference fixture's signature over both engines → the
    reference's diagnostics, after the port's are held equal to them."""
    roots = {}
    for side in ("ref", "port"):
        roots[side] = tmp_path / side
        roots[side].mkdir()
        (roots[side] / "pyproject.toml").write_text("")

    def run(files: dict, per_file: bool = False):
        for rel, src in files.items():
            write(roots["ref"], rel, src)
            write(roots["port"], reroot(rel), reroot_imports(src))
        want = ref_lint_paths([str(roots["ref"] / "kepler_tpu")],
                              root=str(roots["ref"]),
                              per_file=per_file).diagnostics
        got = lint_paths([str(roots["port"] / "kepler_tpu_torch")],
                         root=str(roots["port"]),
                         per_file=per_file).diagnostics
        assert key(got) == [(reroot(p), *rest) for p, *rest in key(want)], (
            f"port {[d.render() for d in got]} != reference "
            f"{[d.render() for d in want]}")
        return want

    return run


class TestLockOrder(ref.TestLockOrder):
    pass


class TestTaint(ref.TestTaint):
    pass


class TestThreadRoles(ref.TestThreadRoles):
    pass


# ---------------------------------------------------------------------------
# tree scoping
# ---------------------------------------------------------------------------


def test_metric_rule_fires_in_benchmarks(tmp_path):
    (tmp_path / "pyproject.toml").write_text("")
    write(tmp_path, "benchmarks/bench_mod.py", """
        from prometheus_client.core import GaugeMetricFamily

        def fam():
            return GaugeMetricFamily("kepler_bench_badsuffix", "d")
    """)
    diags = lint_paths([str(tmp_path / "benchmarks")],
                       root=str(tmp_path)).diagnostics
    assert [d.rule_id for d in diags] == ["KTL105"]


def test_explicit_path_outside_scoped_trees_gets_all_rules(tmp_path):
    """chip_smoke.py sits outside every scoped tree: it gets every rule."""
    (tmp_path / "pyproject.toml").write_text("")
    path = write(tmp_path, "chip_smoke.py", """
        # keplint: monotonic-only
        import time

        def f():
            return time.time()

        def delta(zone, prev_energy_uj):
            return zone.energy() - prev_energy_uj
    """)
    diags = lint_paths([path], root=str(tmp_path)).diagnostics
    assert [d.rule_id for d in diags] == ["KTL101", "KTL102"]


def test_reference_tree_is_out_of_the_port_scopes(tmp_path):
    """The port's path-scoped rules name the port's files: the wrap-aware
    helper is exempt at ``kepler_tpu_torch/ops/deltas.py`` only."""
    (tmp_path / "pyproject.toml").write_text("")
    src = """
        def delta(zone, prev_energy_uj):
            return zone.energy() - prev_energy_uj
    """
    write(tmp_path, "kepler_tpu_torch/ops/deltas.py", src)
    write(tmp_path, "kepler_tpu_torch/ops/other.py", src)
    diags = lint_paths([str(tmp_path / "kepler_tpu_torch")],
                       root=str(tmp_path)).diagnostics
    assert [(d.path, d.rule_id) for d in diags] == [
        ("kepler_tpu_torch/ops/other.py", "KTL102")]


# ---------------------------------------------------------------------------
# CLI on a cross-module finding
# ---------------------------------------------------------------------------


def _cross_taint_tree(tmp_path) -> str:
    (tmp_path / "pyproject.toml").write_text("")
    for rel, src in ref._CROSS_TAINT_BAD.items():
        write(tmp_path, reroot(rel), reroot_imports(src))
    return str(tmp_path / "kepler_tpu_torch")


def test_sarif_carries_the_cross_module_finding(tmp_path, capsys):
    assert keplint_main([_cross_taint_tree(tmp_path), "--format=sarif"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["version"] == "2.1.0"
    res = doc["runs"][0]["results"][0]
    assert res["ruleId"] == "KTL112" and res["level"] == "error"
    loc = res["locations"][0]["physicalLocation"]
    assert loc["artifactLocation"]["uri"].startswith("kepler_tpu_torch/")
    assert loc["artifactLocation"]["uri"].endswith("sink_mod.py")


def test_json_and_per_file(tmp_path, capsys):
    target = _cross_taint_tree(tmp_path)
    assert keplint_main([target, "--format=json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["failed"] is True
    assert doc["violations"][0]["rule"] == "KTL112"
    # the finding needs the call graph: gone in per-file mode
    assert keplint_main([target, "--per-file"]) == 0


def test_full_port_tree_stays_under_budget():
    """The reference's budget for its full tree (8 s on a 2-core host)
    holds for the port's (kepler_tpu_torch and chip_smoke.py), here at
    twice the margin for the parallel tier-1 run's load."""
    t0 = time.monotonic()
    result = lint_paths([os.path.join(REPO, t) for t in DEFAULT_TREES],
                        root=REPO)
    elapsed = time.monotonic() - t0
    assert result.diagnostics == []
    assert elapsed < 16.0, f"port keplint took {elapsed:.2f}s (budget 16s)"
