"""kepmc on the port (``kepler_tpu_torch.analysis.protocol``) against the
reference.

The port's protocol models drive the port's own fleet functions
(``kepler_tpu_torch/fleet/membership.py`` and ``delivery.py``). Each
registry case must explore exactly the reference's state space (states,
transitions, depth) with no violation — the counts ``chip_smoke.py``
holds the card's run to. The reference's five bug mutations (a
hard-coded lease issuer, a skipped demote early-return, a skipped
ownership re-seed, an ignored needs-keyframe flag, a duplicate keyframe
that plants no base) applied to the port's functions must yield the same
minimal counterexample schedules. KTL133's fixtures run through both
engines; the runner and the CLI's ``--protocol-tier`` exit 0.
"""

from __future__ import annotations

import os
import re
import textwrap

import pytest

import chip_smoke
import test_protocol as ref
from kepler_tpu.analysis import protocol as jproto
from kepler_tpu.analysis.engine import lint_file as ref_lint_file
from kepler_tpu_torch.analysis import all_rules
from kepler_tpu_torch.analysis.__main__ import main as keplint_main
from kepler_tpu_torch.analysis.engine import lint_file
from kepler_tpu_torch.analysis.protocol import (PROTOCOL_SPECS,
                                                analyze_protocol_specs,
                                                build_model, explore,
                                                explore_case)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = [(spec, case) for spec in PROTOCOL_SPECS for case in spec.cases]


@pytest.mark.parametrize("spec,case", CASES,
                         ids=[f"{s.name}/{c.name}" for s, c in CASES])
def test_state_space_equals_the_reference(spec, case):
    got = explore_case(spec, case).result
    jspec = jproto.spec_by_name(spec.name)
    jcase = next(c for c in jspec.cases if c.name == case.name)
    want = jproto.explore_case(jspec, jcase).result
    assert got.ok, "\n\n".join(c.format() for c in got.counterexamples)
    assert (got.states, got.transitions, got.depth) == (
        want.states, want.transitions, want.depth)
    assert chip_smoke.PROTOCOL_COUNTS[f"{spec.name}/{case.name}"] == (
        got.states, got.transitions)
    assert spec.source.startswith("kepler_tpu_torch/fleet/")
    assert os.path.exists(os.path.join(REPO, spec.source))


def test_chip_smoke_pins_every_case():
    assert set(chip_smoke.PROTOCOL_COUNTS) == {
        f"{s.name}/{c.name}" for s, c in CASES}


# (model, params, variant, invariant, max_states): the reference's five
# mutations, test_protocol.py TestBugVariants
MUTATIONS = {
    "hardcoded_issuer": ("lease", {"replicas": 2, "epoch_cap": 4},
                         "holder-in-peers", 400_000),
    "skip_demote_early_return": ("lease", {"replicas": 3, "epoch_cap": 5},
                                 "no-await-wedge", 60_000),
    "skip_ownership_reseed": ("seq", {}, "no-fabricated-loss", 400_000),
    "ignore_needs_flag": ("keyframe", {}, "409-converges", 400_000),
    "dup_kf_skips_base": ("keyframe", {}, "dup-keyframe-plants-base",
                          400_000),
}


@pytest.mark.parametrize("variant", sorted(MUTATIONS))
def test_mutation_yields_the_reference_counterexample(variant):
    name, params, invariant, cap = MUTATIONS[variant]
    model = build_model(name, params, variant)
    got = explore(model, max_states=cap)
    want = jproto.explore(jproto.build_model(name, params, variant),
                          max_states=cap)
    assert not got.ok

    def cex(result):
        return next(c for c in result.counterexamples
                    if c.invariant == invariant)

    assert cex(got).trace == cex(want).trace
    final = ref.replay(model, cex(got).trace)
    assert invariant in ref.violated(model, final)


def test_runner_is_clean_and_flows_a_mutation_through_its_rule():
    assert analyze_protocol_specs(REPO) == []
    spec = PROTOCOL_SPECS[0]
    case = spec.cases[0]
    from kepler_tpu_torch.analysis.protocol import ModelReport

    model = build_model(spec.model, case.params, "hardcoded_issuer")
    report = ModelReport(spec=spec, case=case,
                         result=explore(model, max_states=case.max_states))
    rule = next(r for r in all_rules() if r.id == "KTL130")
    diags = list(rule.check_model(report))
    assert [d.rule_id for d in diags] == ["KTL130"]
    assert diags[0].path == "kepler_tpu_torch/fleet/membership.py"
    assert "leave(a)" in diags[0].message


def test_cli_protocol_tier_exits_zero(capsys):
    assert keplint_main(["--protocol-tier", "--only=KTL130,KTL131,KTL132",
                         os.path.join(REPO, "kepler_tpu_torch", "fleet")]
                        ) == 0
    assert "clean" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# KTL133, the transition-marker fence, through both engines
# ---------------------------------------------------------------------------


@pytest.fixture()
def lint133(tmp_path):
    """The reference fixture's signature over both engines (only KTL133);
    the port's fence is ``kepler_tpu_torch/fleet/``."""
    ref_rule = next(r for r in ref.all_rules() if r.id == "KTL133")
    port_rule = next(r for r in all_rules() if r.id == "KTL133")

    def run(source, rel="kepler_tpu/fleet/mod.py"):
        out = {}
        for side, fix, engine, rule in (
                ("ref", lambda r: r, ref_lint_file, ref_rule),
                ("port", lambda r: re.sub(r"^kepler_tpu/",
                                          "kepler_tpu_torch/", r),
                 lint_file, port_rule)):
            root = tmp_path / side
            (root / "pyproject.toml").parent.mkdir(exist_ok=True)
            (root / "pyproject.toml").write_text("")
            path = root / fix(rel)
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(textwrap.dedent(source))
            out[side] = engine(str(path), str(root), rules=[rule])
        assert [(d.rule_id, d.line, d.col, d.severity)
                for d in out["port"]] == [
            (d.rule_id, d.line, d.col, d.severity) for d in out["ref"]]
        return out["ref"]

    return run


class TestTransitionMarker(ref.TestTransitionMarker):
    pass


def test_port_fleet_tree_keeps_its_transition_markers():
    rule = next(r for r in all_rules() if r.id == "KTL133")
    fleet = os.path.join(REPO, "kepler_tpu_torch", "fleet")
    for name in sorted(os.listdir(fleet)):
        if name.endswith(".py"):
            assert lint_file(os.path.join(fleet, name), REPO,
                             rules=[rule]) == [], name
