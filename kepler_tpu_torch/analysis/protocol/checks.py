"""kepmc check families KTL130-132 + the protocol-tier runner.

Each rule consumes the :class:`ModelReport` of one registry case — the
exhaustive exploration of the shipped transition code at that case's
scope — and yields engine :class:`~kepler_tpu_torch.analysis.engine
.Diagnostic`\\ s anchored at the protocol's home module, so
protocol-tier findings ride the same severity, baseline-ratchet and
text/json/SARIF machinery as every other keplint rule. Explorations
are cached per (spec, case) for the life of the process.

A counterexample's diagnostic carries the FULL minimal event trace:
the finding is a schedule, and the schedule is the review surface.
The baseline stays EMPTY for this tier by policy — a reachable
protocol violation is a bug to fix, never a debt to grandfather.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

from kepler_tpu_torch.analysis.engine import (
    Diagnostic,
    ProtocolRule,
    SEVERITY_ERROR,
    register,
)
from kepler_tpu_torch.analysis.protocol.explorer import (
    ExplorationResult,
    explore,
)
from kepler_tpu_torch.analysis.protocol.registry import (
    PROTOCOL_SPECS,
    ProtocolCase,
    ProtocolSpec,
)

__all__ = [
    "INVARIANT_RULE",
    "ModelReport",
    "PROTOCOL_RULE_IDS",
    "analyze_protocol_specs",
    "clear_exploration_cache",
    "explore_case",
]

PROTOCOL_RULE_IDS = ("KTL130", "KTL131", "KTL132")

#: invariant name (Counterexample.invariant) → owning rule id. Every
#: invariant a registered model can emit MUST appear here — an unmapped
#: counterexample reports under KTL000 so it cannot vanish silently.
INVARIANT_RULE: dict[str, str] = {
    # epoch safety (KTL130)
    "no-split-brain": "KTL130",
    "holder-in-peers": "KTL130",
    "contiguous-epochs": "KTL130",
    "no-await-wedge": "KTL130",
    # loss accounting (KTL131)
    "no-fabricated-loss": "KTL131",
    "cursor-no-skip": "KTL131",
    "stale-ack-rejected": "KTL131",
    "rewind-bounded": "KTL131",
    # replay idempotence (KTL132)
    "replay-idempotent": "KTL132",
    "409-converges": "KTL132",
    "dup-keyframe-plants-base": "KTL132",
}


@dataclasses.dataclass(frozen=True)
class ModelReport:
    """One registry case's exhaustive exploration of the SHIPPED code."""

    spec: ProtocolSpec
    case: ProtocolCase
    result: ExplorationResult

    @property
    def key(self) -> str:
        return f"{self.spec.name}/{self.case.name}"


# process-lifetime exploration cache: (spec.name, case.name) → report
_EXPLORE_CACHE: dict[tuple[str, str], ModelReport] = {}


def clear_exploration_cache() -> None:
    _EXPLORE_CACHE.clear()


def explore_case(spec: ProtocolSpec, case: ProtocolCase) -> ModelReport:
    """Explore one registry case (shipped variant), cached."""
    from kepler_tpu_torch.analysis.protocol.models import build_model

    key = (spec.name, case.name)
    report = _EXPLORE_CACHE.get(key)
    if report is None:
        model = build_model(spec.model, case.params)
        result = explore(model, max_states=case.max_states)
        report = ModelReport(spec=spec, case=case, result=result)
        _EXPLORE_CACHE[key] = report
    return report


def _diag(rule_id: str, severity: str, report: ModelReport,
          message: str) -> Diagnostic:
    return Diagnostic(
        path=report.spec.source, line=1, col=1, rule_id=rule_id,
        severity=severity, message=f"[{report.key}] {message}")


class _InvariantRule(ProtocolRule):
    """Shared shape: report every counterexample whose invariant this
    rule owns, with its minimal event trace inline."""

    def check_model(self, report: ModelReport) -> Iterable[Diagnostic]:
        for cex in report.result.counterexamples:
            if INVARIANT_RULE.get(cex.invariant) != self.id:
                continue
            yield _diag(self.id, self.severity, report, cex.format())


@register
class EpochSafetyRule(_InvariantRule):
    id = "KTL130"
    name = "protocol-epoch-safety"
    summary = ("exhaustive exploration of the lease/succession model "
               "finds no reachable epoch-safety violation: no two live "
               "holders at one epoch, every adopted holder inside its "
               "membership, epochs contiguous (at most one bump per "
               "succession), no awaiting-forever wedge")
    rationale = (
        "The coordinator lease is the fleet's only writer-election "
        "mechanism: a split-brain (two live replicas believing they "
        "hold the lease at the SAME epoch) double-drives autoscale and "
        "membership, and an epoch that jumps by more than one per "
        "succession breaks the redirect-ordering contract every agent "
        "relies on. The chaos suite samples a few dozen interleavings; "
        "all three membership bugs hid in schedules it did not draw. This "
        "rule explores EVERY schedule at the registry scopes — crash, "
        "notice, leave, restart-join, duplicated and reordered "
        "broadcasts — through the real plan_succession / "
        "plan_membership_apply / CoordinatorLease.adopt, and fails "
        "with the minimal event trace when any reachable state "
        "violates epoch safety (including the broadcast-lands-before-"
        "demote wedge, rediscovered from the pre-fix code by this "
        "exact check).")


@register
class LossAccountingRule(_InvariantRule):
    id = "KTL131"
    name = "protocol-loss-accounting"
    summary = ("exhaustive exploration of the delivery-plane models "
               "finds no reachable loss-accounting violation: no "
               "fabricated loss counts, no spool record skipped or "
               "stale-acked, rewinds bounded to concluded records")
    rationale = (
        "`windows_lost` is the fleet's data-integrity metric: "
        "operators page on it, and the at-least-once delivery design "
        "(spool + dedup window + watermark seeding) exists so that a "
        "membership change is replay, NOT loss. A seq tracker that "
        "counts a gap for windows that were delivered to their "
        "then-owner fabricates exactly the signal the metric exists "
        "to catch (the ownership-return bug), and a spool "
        "cursor that hops past an un-acked record silently loses it. "
        "This rule drives the REAL SeqTracker seeding/observe rules "
        "and the REAL plan_ack_cursor / plan_rewind_tail through "
        "every FIFO delivery, response-loss, rewind, scale-flap, "
        "restart and eviction schedule at the registry scopes, and "
        "fails with the minimal trace when any reachable state counts "
        "loss for a delivered window or moves the cursor wrong.")


@register
class ReplayIdempotenceRule(_InvariantRule):
    id = "KTL132"
    name = "protocol-replay-idempotence"
    summary = ("exhaustive exploration finds replays idempotent: "
               "re-delivered seqs never count loss, duplicate "
               "keyframes still plant the delta base, and a 409 "
               "needs-keyframe answer converges in one round trip")
    rationale = (
        "At-least-once delivery makes duplicates a steady-state "
        "condition, not an edge case: every spool rewind, dropped "
        "2xx and ownership hand-off re-delivers concluded seqs. The "
        "protocol is only correct if replay is a no-op everywhere — "
        "the dedup window absorbs the seq, the duplicate keyframe "
        "STILL plants the server-side delta base (else the hand-off "
        "replay can never re-arm deltas), and a 409 forces a keyframe "
        "that cannot itself 409 (one round trip to convergence, never "
        "a loop). This rule explores the real keyframe_wanted / "
        "delta_base_matches machine and the real tracker replay path "
        "under every duplicate/reorder/hand-off schedule at the "
        "registry scopes and fails with the minimal trace when any "
        "replay changes accounting or the 409 loop fails to converge.")


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------


def analyze_protocol_specs(
        root: str,
        only: set[str] | None = None,
        specs: tuple[ProtocolSpec, ...] = PROTOCOL_SPECS,
) -> list[Diagnostic]:
    """Explore every registry case and run the protocol-tier families.

    ``only`` restricts to a subset of rule ids (the CLI's ``--only``);
    model build/exploration failures always report (as KTL000).
    ``root`` is unused (kept for runner-signature symmetry with the
    device tier).
    """
    del root
    from kepler_tpu_torch.analysis.engine import REGISTRY

    def want(rule_id: str) -> bool:
        return only is None or rule_id in only

    diags: list[Diagnostic] = []
    rules = [REGISTRY[rid] for rid in PROTOCOL_RULE_IDS if want(rid)]
    if not rules:
        return diags
    for spec in specs:
        for case in spec.cases:
            try:
                report = explore_case(spec, case)
            except Exception as err:  # StateExplosionError included
                diags.append(Diagnostic(
                    path=spec.source, line=1, col=1, rule_id="KTL000",
                    severity=SEVERITY_ERROR,
                    message=f"[{spec.name}/{case.name}] protocol model "
                            f"failed to build/explore: "
                            f"{type(err).__name__}: {str(err)[:300]}"))
                continue
            for rule in rules:
                diags.extend(rule.check_model(report))
            # an invariant outside INVARIANT_RULE must not vanish just
            # because no rule claimed it
            for cex in report.result.counterexamples:
                if cex.invariant not in INVARIANT_RULE:
                    diags.append(_diag(
                        "KTL000", SEVERITY_ERROR, report,
                        f"counterexample for unmapped invariant "
                        f"{cex.invariant!r}: {cex.format()}"))
    return sorted(diags)
