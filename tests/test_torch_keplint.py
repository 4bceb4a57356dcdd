"""keplint on the port (``kepler_tpu_torch.analysis``) against the reference.

Every per-file rule's fixture snippets of ``tests/test_keplint.py`` run
through BOTH engines: the reference engine at the snippet's path, the
port's at the same path re-rooted under ``kepler_tpu_torch/`` (the
port's rule scopes name its own tree). The ``(rule_id, line, col,
severity)`` lists must be equal; the reference test's own assertions then
run on them. The reference classes are reused rule by rule (one class per
rule, every fixture a case), with the ``lint`` fixture swapped for the
two-engine one below.

Beside the parity: the port's own meanings of KTL107, KTL109 and KTL110
(kernel wrappers and plain versions, in-place updates) each fire on a
planted defect; KTL104 against a re-rooted config schema; the baseline
ratchet and the CLI (exit codes, json, sarif, ``--device``); and the
shipped port tree lints clean with the port's empty baseline.
"""

from __future__ import annotations

import json
import os
import re
import textwrap

import pytest

import test_keplint as ref
from kepler_tpu.analysis.engine import lint_file as ref_lint_file
from kepler_tpu_torch.analysis import Baseline, all_rules, lint_paths
from kepler_tpu_torch.analysis.__main__ import (BASELINE_NAME,
                                                DEFAULT_TREES)
from kepler_tpu_torch.analysis.__main__ import main as keplint_main
from kepler_tpu_torch.analysis.engine import REGISTRY, lint_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reroot(rel: str) -> str:
    """``kepler_tpu/x.py`` → ``kepler_tpu_torch/x.py``; other trees
    (hack/, benchmarks/, tests/) stay."""
    return re.sub(r"^kepler_tpu/", "kepler_tpu_torch/", rel)


def reroot_imports(source: str) -> str:
    """Point a fixture's own imports at the port's tree. Only import
    lines change, so no finding's line or column moves."""
    return re.sub(r"^(\s*(?:from|import)\s+)kepler_tpu\b",
                  r"\1kepler_tpu_torch", source, flags=re.MULTILINE)


def key(diags) -> list[tuple]:
    return [(d.rule_id, d.line, d.col, d.severity) for d in diags]


def write(root, rel, source):
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    return str(path)


@pytest.fixture()
def lint(tmp_path):
    """The reference fixture's signature over both engines: the port's
    findings must equal the reference's; → the reference's diagnostics
    (paths as the reference test expects them)."""
    roots = {}
    for side in ("ref", "port"):
        roots[side] = tmp_path / side
        roots[side].mkdir()
        (roots[side] / "pyproject.toml").write_text("")

    def run(source, rel="kepler_tpu/mod.py", rules=None):
        want = ref_lint_file(write(roots["ref"], rel, source),
                             str(roots["ref"]), rules=rules)
        port_rules = None if rules is None else [REGISTRY[r.id]
                                                 for r in rules]
        got = lint_file(write(roots["port"], reroot(rel), source),
                        str(roots["port"]), rules=port_rules)
        assert key(got) == key(want), (
            f"port {[d.render() for d in got]} != reference "
            f"{[d.render() for d in want]}")
        assert all(d.path == reroot(w.path) for d, w in zip(got, want))
        return want

    return run


# every reference class whose tests lint fixture snippets through the
# `lint` fixture: one class per rule family, each fixture a case
class TestEngine(ref.TestEngine):
    def test_registry_has_twenty_two_domain_rules(self):
        rules = all_rules()
        assert [r.id for r in rules] == [r.id for r in ref.all_rules()]
        assert len({r.name for r in rules}) == 22
        for r in rules:
            assert r.summary and r.rationale, f"{r.id} lacks docs"


class TestMonotonicClockRule(ref.TestMonotonicClockRule):
    pass


class TestWrapAwareDeltaRule(ref.TestWrapAwareDeltaRule):
    pass


class TestSnapshotImmutableRule(ref.TestSnapshotImmutableRule):
    pass


class TestMetricNameRule(ref.TestMetricNameRule):
    pass


class TestHotLoopBlockingRule(ref.TestHotLoopBlockingRule):
    pass


class TestJitPureRule(ref.TestJitPureRule):
    pass


class TestLockGuardedRule(ref.TestLockGuardedRule):
    pass


class TestSpanDisciplineRule(ref.TestSpanDisciplineRule):
    pass


class TestDonatedBufferRule(ref.TestDonatedBufferRule):
    pass


class TestFusedScanFixtures(ref.TestFusedScanFixtures):
    pass


class TestPackedLayoutRule(ref.TestPackedLayoutRule):
    pass


# ---------------------------------------------------------------------------
# KTL104 against a re-rooted schema
# ---------------------------------------------------------------------------


CONFIG_CASES = {
    "undeclared": ("kepler_tpu/use.py", """
        def run(cfg):
            return cfg.monitor.intervall
    """, ("monitor.interval", "monitor.staleness"), ["KTL104"]),
    "declared_and_methods": ("kepler_tpu/use.py", """
        def run(cfg):
            cfg.validate()
            return cfg.monitor.interval + cfg.monitor.staleness
    """, ("monitor.interval", "monitor.staleness"), []),
    "section_local_cfg": ("kepler_tpu/fault_like.py", """
        def from_config(cfg):
            return cfg.seed, cfg.specs
    """, ("monitor.interval", "monitor.staleness"), []),
    "undocumented_leaf": ("kepler_tpu/config/config.py", None,
                          ("monitor.interval",), ["KTL104"]),
}


@pytest.mark.parametrize("case", sorted(CONFIG_CASES))
def test_config_rule_matches_the_reference(tmp_path, case):
    rel, source, documented, want_ids = CONFIG_CASES[case]
    got = {}
    for side, fix in (("ref", lambda r: r), ("port", reroot)):
        root = tmp_path / side
        (root).mkdir()
        (root / "pyproject.toml").write_text("")
        write(root, fix("kepler_tpu/config/config.py"), ref.SCHEMA_FIXTURE)
        entries = "".join(f'    "{k}": "doc",\n' for k in documented)
        write(root, "hack/gen_config_docs.py",
              "DESCRIPTIONS = {\n" + entries + "}\n")
        path = (str(root / fix(rel)) if source is None
                else write(root, fix(rel), source))
        engine = ref_lint_file if side == "ref" else lint_file
        got[side] = engine(path, str(root))
    assert key(got["port"]) == key(got["ref"])
    assert [d.rule_id for d in got["port"]] == want_ids


def test_config_rule_reads_the_port_schema_on_the_shipped_tree():
    path = os.path.join(REPO, "kepler_tpu_torch", "cmd", "main.py")
    assert [d for d in lint_file(path, REPO) if d.rule_id == "KTL104"] == []


# ---------------------------------------------------------------------------
# the port's meanings of KTL107, KTL109, KTL110
# ---------------------------------------------------------------------------


PORT_FIXTURES = {
    # KTL107: a wall clock in a plain version (the kernel's parity target)
    "ktl107_clock_in_plain_version": ("kepler_tpu_torch/ops/cuda_x.py", """
        import time

        def outer_ref(ratio, active):
            stamp = time.time()
            return ratio[:, :, None] * active[:, None, :], stamp
    """, ["KTL107"]),
    "ktl107_host_rng_in_kernel_wrapper": ("kepler_tpu_torch/ops/cuda_x.py",
                                          """
        import numpy as np

        def outer(ratio, out, lib):
            jitter = np.random.uniform()
            lib.kt_outer(ratio.data_ptr(), out.data_ptr())
            return out, jitter
    """, ["KTL107"]),
    "ktl107_global_in_autograd_forward": ("kepler_tpu_torch/ops/fn.py", """
        import torch

        CALLS = 0

        class Scale(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                global CALLS
                CALLS += 1
                return x * 2

            @staticmethod
            def backward(ctx, g):
                return g * 2
    """, ["KTL107"]),
    "ktl107_pure_plain_version_is_clean": ("kepler_tpu_torch/ops/cuda_x.py",
                                           """
        def outer_ref(ratio, active):
            return ratio[:, :, None] * active[:, None, :]
    """, []),
    "ktl109_span_in_kernel_wrapper": ("kepler_tpu_torch/ops/cuda_x.py", """
        from kepler_tpu_torch import telemetry

        def outer(ratio, out, lib):
            with telemetry.span("b1"):
                lib.kt_outer(ratio.data_ptr(), out.data_ptr())
            return out
    """, ["KTL109"]),
    "ktl109_span_in_plain_version": ("kepler_tpu_torch/ops/cuda_x.py", """
        from kepler_tpu_torch.telemetry import span

        def outer_ref(ratio, active):
            with span("b1.plain"):
                return ratio[:, :, None] * active[:, None, :]
    """, ["KTL109"]),
    "ktl109_span_at_call_site_is_clean": ("kepler_tpu_torch/ops/use.py", """
        from kepler_tpu_torch import telemetry

        def window(ratio, active, outer):
            with telemetry.span("window.attribute"):
                return outer(ratio, active)
    """, []),
    "ktl110_alias_read_after_in_place_update": (
        "kepler_tpu_torch/fleet/window.py", """
        def sync(self, rows, idx):
            update = self._update  # keplint: donates=0
            resident = self._buffers[0]
            update(resident, rows, idx)
            return resident.sum()
    """, ["KTL110"]),
    "ktl110_rebind_after_in_place_update_is_clean": (
        "kepler_tpu_torch/fleet/window.py", """
        def sync(self, rows, idx):
            update = self._update  # keplint: donates=0
            resident = self._buffers[0]
            resident = update(resident, rows, idx)
            return resident.sum()
    """, []),
}


@pytest.mark.parametrize("case", sorted(PORT_FIXTURES))
def test_port_meaning_fires_on_its_planted_defect(tmp_path, case):
    rel, source, want = PORT_FIXTURES[case]
    (tmp_path / "pyproject.toml").write_text("")
    diags = lint_file(write(tmp_path, rel, source), str(tmp_path))
    assert [d.rule_id for d in diags] == want, [d.render() for d in diags]


# ---------------------------------------------------------------------------
# baseline ratchet and CLI
# ---------------------------------------------------------------------------


def _two_clock_findings(tmp_path):
    (tmp_path / "pyproject.toml").write_text("")
    write(tmp_path, "kepler_tpu_torch/mod.py", ref.TestBaselineRatchet.SOURCE)
    return lint_paths([str(tmp_path / "kepler_tpu_torch")],
                      root=str(tmp_path)).diagnostics


def test_baseline_tolerates_then_ratchets(tmp_path):
    diags = _two_clock_findings(tmp_path)
    assert [d.rule_id for d in diags] == ["KTL101", "KTL101"]
    full = Baseline.from_diagnostics(diags).apply(diags)
    assert (full.diagnostics, full.baselined, full.failed) == ([], 2, False)
    one = Baseline({diags[0].baseline_key: 1}).apply(diags)
    assert one.failed and one.diagnostics[0].line == diags[1].line
    stale = Baseline({diags[0].baseline_key: 5}).apply(diags)
    assert stale.stale_entries == [diags[0].baseline_key]
    path = str(tmp_path / "keplint.json")
    Baseline.from_diagnostics(diags).save(path)
    assert Baseline.load(path).counts == {diags[0].baseline_key: 2}


def test_cli_exit_codes(tmp_path, capsys):
    (tmp_path / "pyproject.toml").write_text("")
    write(tmp_path, "kepler_tpu_torch/ok.py", "X = 1\n")
    target = str(tmp_path / "kepler_tpu_torch")
    assert keplint_main([target]) == 0
    assert "clean" in capsys.readouterr().out
    write(tmp_path, "kepler_tpu_torch/mod.py", ref.TestBaselineRatchet.SOURCE)
    assert keplint_main([target]) == 1
    # the port's baseline lives in its package, never the root file
    assert keplint_main([target, "--write-baseline"]) == 0
    assert os.path.exists(tmp_path / BASELINE_NAME)
    assert not os.path.exists(tmp_path / ".keplint.json")
    assert keplint_main([target]) == 0
    assert keplint_main([target, "--no-baseline"]) == 1
    assert keplint_main([str(tmp_path / "nope")]) == 2
    assert keplint_main(["--only=KTL999", target]) == 2


@pytest.mark.parametrize("fmt", ["json", "sarif"])
def test_cli_formats_match_the_reference(tmp_path, capsys, fmt):
    from kepler_tpu.analysis.__main__ import main as ref_main

    docs = {}
    for side, main, rel in (("ref", ref_main, "kepler_tpu"),
                            ("port", keplint_main, "kepler_tpu_torch")):
        root = tmp_path / side
        root.mkdir()
        (root / "pyproject.toml").write_text("")
        write(root, f"{rel}/mod.py", ref.TestBaselineRatchet.SOURCE)
        assert main([str(root / rel), f"--format={fmt}",
                     "--no-baseline"]) == 1
        docs[side] = json.loads(capsys.readouterr().out)
    if fmt == "json":
        def rows(doc):
            return [(v["rule"], v["line"], v["col"], v["severity"])
                    for v in doc["violations"]]
        assert rows(docs["port"]) == rows(docs["ref"])
        assert docs["port"]["failed"] is True
        assert docs["port"]["violations"][0]["path"] == \
            "kepler_tpu_torch/mod.py"
    else:
        port, want = docs["port"]["runs"][0], docs["ref"]["runs"][0]
        assert docs["port"]["version"] == "2.1.0"
        assert [r["id"] for r in port["tool"]["driver"]["rules"]] == \
            [r["id"] for r in want["tool"]["driver"]["rules"]]

        def rows(run):
            return [(r["ruleId"], r["level"],
                     r["locations"][0]["physicalLocation"]["region"][
                         "startLine"]) for r in run["results"]]
        assert rows(port) == rows(want)


def test_cli_list_rules(capsys):
    assert keplint_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rid in ("KTL101", "KTL110", "KTL120", "KTL133"):
        assert rid in out


# ---------------------------------------------------------------------------
# the shipped port tree
# ---------------------------------------------------------------------------


def test_port_tree_lints_clean_with_no_baseline():
    """The acceptance gate: the port and chip_smoke.py, every rule
    (whole-program ones included), nothing baselined."""
    result = lint_paths([os.path.join(REPO, t) for t in DEFAULT_TREES],
                        root=REPO)
    assert result.diagnostics == [], "\n".join(
        d.render() for d in result.diagnostics)


def test_committed_port_baseline_is_empty():
    assert Baseline.load(os.path.join(REPO, BASELINE_NAME)).counts == {}


def test_default_run_exits_zero(capsys):
    assert keplint_main([os.path.join(REPO, t) for t in DEFAULT_TREES]) == 0
    assert capsys.readouterr().out.strip() == "keplint: clean"
