"""The port's device-tier check families KTL120-123 + the runner.

Each rule consumes the :class:`~kepler_tpu_torch.analysis.device.trace
.TraceReport` of one registry case and yields engine
:class:`~kepler_tpu_torch.analysis.engine.Diagnostic`\\ s anchored at the
program's home module, so device-tier findings ride the same severity,
baseline-ratchet and text/json/SARIF machinery as every other keplint
rule. Runs are cached per (spec, case, device) for the life of the
process — the dominant cost is running, paid once however many families
check it.

The KTL123 golden snapshots are the port's own,
``kepler_tpu_torch/analysis/device/kepltorch.json`` (aten op names, not
jaxpr primitives; ``--update-snapshots --device cpu`` regenerates); the
committed file is the ratchet — structural drift in any registered
program fails lint with a field-level diff.
"""

from __future__ import annotations

import json
import os
from typing import Iterable

from kepler_tpu_torch.analysis.engine import (
    Diagnostic,
    DeviceRule,
    SEVERITY_ERROR,
    register,
)
from kepler_tpu_torch.analysis.device.registry import (
    DEVICE_PROGRAMS,
    ProgramSpec,
)
from kepler_tpu_torch.analysis.device.trace import TraceReport, fingerprint

SNAPSHOT_NAME = "kepler_tpu_torch/analysis/device/kepltorch.json"
SNAPSHOT_VERSION = 1

DEVICE_RULE_IDS = ("KTL120", "KTL121", "KTL122", "KTL123")

# process-lifetime run cache: (spec.name, case.name, device) → TraceReport
_TRACE_CACHE: dict[tuple[str, str, str], TraceReport] = {}


def clear_trace_cache() -> None:
    _TRACE_CACHE.clear()


def _diag(rule: DeviceRule, report: TraceReport, message: str) -> Diagnostic:
    return Diagnostic(
        path=report.spec.source, line=1, col=1, rule_id=rule.id,
        severity=rule.severity,
        message=f"[{report.key}] {message}")


@register
class DtypeFlowRule(DeviceRule):
    id = "KTL120"
    name = "dtype-flow"
    summary = ("half precision (f16/bf16) never accumulates: no half "
               "dot accumulators or reduction operands, and half casts "
               "only at the boundaries the registry entry declares")
    rationale = (
        "The packed fleet wire format quantizes watts to f16 at exactly "
        "one declared boundary (~0.05% error, inside the 0.5%-of-RAPL "
        "budget) and estimator trunks round their OPERANDS to bf16 and "
        "multiply in f32 (`models.nn.acc_matmul`). That budget only "
        "holds while those are the ONLY half-precision touchpoints: a "
        "bare `x16 @ w16` rounds every partial sum to ~3 decimal digits, "
        "and a stray `.to(torch.float16)` mid-program quantizes an "
        "intermediate, both silently. This check reads every registered "
        "program's recorded run: any product (mm, bmm, addmm, …) with a "
        "half-precision output, any reduction over half operands, and "
        "any half cast pair (`_to_copy` with a dtype, a cross-dtype "
        "`copy_`) outside the entry's `allowed_half_casts` declaration "
        "is a finding.")

    def check_trace(self, report: TraceReport) -> Iterable[Diagnostic]:
        for desc in report.half_products:
            yield _diag(self, report,
                        f"product accumulates in half precision "
                        f"({desc}); keep the result f32 "
                        f"(models.nn.acc_matmul)")
        for desc in report.half_reduces:
            yield _diag(self, report,
                        f"reduction over half-precision operands "
                        f"({desc}); accumulate in f32")
        allowed = report.spec.allowed_half_casts
        for pair, count in sorted(report.half_casts.items()):
            if pair not in allowed:
                yield _diag(
                    self, report,
                    f"undeclared half-precision cast {pair} (×{count}); "
                    f"declared boundaries: "
                    f"{sorted(allowed) or 'none'}")


@register
class DonationAliasRule(DeviceRule):
    id = "KTL121"
    name = "donation-alias"
    summary = ("the entry's `donates` contract is real: every declared "
               "argument is updated in place with no whole copy made, "
               "and nothing else is updated")
    rationale = (
        "The port's form of the reference's donated buffer is an "
        "argument the program updates IN PLACE: the resident fleet batch "
        "of the window programs, the train state of the train steps. "
        "The contract is only real while the run keeps to it. A program "
        "that rebuilds the batch functionally (`torch.where(hit, new, "
        "resident)`, a `clone`, a `.to()`) and copies the result back "
        "pays a whole-batch copy every window — the silent perf cliff "
        "the reference's check exists to catch — and a program that "
        "stops writing the argument leaves the caller's handle stale "
        "while KTL110's rebind discipline assumes it is current. The "
        "reverse is worse: an UNdeclared in-place update rewrites a "
        "tensor the caller still reads as its own. The check compares "
        "each flat tensor leaf's version counter before and after the "
        "run (a hand kernel's wrapper advances it for the writes it "
        "makes through raw pointers) against the declared positions, "
        "both directions, and reports every recorded op that copied a "
        "whole declared leaf into new storage.")

    def check_trace(self, report: TraceReport) -> Iterable[Diagnostic]:
        expected: set[int] = set()
        for user_arg in report.spec.donates:
            expected |= report.flat_indices_of_arg(user_arg)
        dropped = sorted(expected - report.updated_args)
        if dropped:
            yield _diag(
                self, report,
                f"declared donation (user args "
                f"{list(report.spec.donates)}) is not realized: flat "
                f"args {dropped} were not updated in place — the caller "
                f"holds stale tensors or every call pays a copy")
        unexpected = sorted(report.updated_args - expected)
        if unexpected:
            yield _diag(
                self, report,
                f"undeclared donation (in-place update) of flat args "
                f"{unexpected}: the caller's tensor is rewritten without "
                f"a `donates` contract saying so")
        for copy in sorted(set(report.copies)):
            yield _diag(self, report,
                        f"declared donation is copied, not updated in "
                        f"place: {copy}")


@register
class CollectiveDisciplineRule(DeviceRule):
    id = "KTL122"
    name = "collective-discipline"
    summary = ("explicit collectives stay inside the entry's allowlist, "
               "and shard-local programs keep their shard_map structure")
    rationale = (
        "The fleet window's scaling contract is that the only "
        "cross-shard step is the caller's result fetch — the packed "
        "program's sparse gather stays shard-local, one body per shard, "
        "and the attention/pipeline/MoE programs each have a KNOWN "
        "collective schedule (ppermute ring, all_to_all pair, …). This "
        "check compares the collectives of `parallel.collectives` a "
        "recorded run called against the entry's allowlist, and "
        "requires `require_shard_map` entries to have run per-shard "
        "bodies (the counterpart of a `shard_map`): a regression to one "
        "program over the whole batch — a replicated-index gather, say "
        "— would move every shard's rows to one place, and losing the "
        "per-shard bodies is how that reads in a recorded run.")

    def check_trace(self, report: TraceReport) -> Iterable[Diagnostic]:
        rogue = report.collectives - report.spec.allowed_collectives
        if rogue:
            yield _diag(
                self, report,
                f"collectives {sorted(rogue)} outside the allowlist "
                f"{sorted(report.spec.allowed_collectives) or '(none)'}")
        if report.spec.require_shard_map and not report.has_shard_map:
            yield _diag(
                self, report,
                "program lost its shard_map structure: it ran no "
                "per-shard body, so cross-shard data movement (e.g. a "
                "replicated-index gather over the whole resident batch) "
                "is no longer shard-local")


@register
class ProgramRatchetRule(DeviceRule):
    id = "KTL123"
    name = "program-ratchet"
    summary = ("each registered program's normalized op fingerprint "
               "matches its committed golden snapshot (kepltorch.json); "
               "drift fails with a diff, --update-snapshots regenerates")
    rationale = (
        "Program structure predicts cost (PAPERS.md: portable "
        "prediction of kernel time/power from program structure) — so "
        "pin the structure. The fingerprint is deliberately normalized "
        "(argument and output signatures, the aten op histogram with "
        "view/alias ops and torch bookkeeping excluded, hand kernels and "
        "optimizer steps as one op each, collective set, half-cast "
        "pairs, shard count, in-place map) so it is the same on the CPU "
        "and on the card, while still catching an accidental extra "
        "copy, a dtype widen, a lost in-place update or a new "
        "collective in review. The histogram is pinned to one torch "
        "version (the one the snapshot was written with); a drift "
        "between versions reads as a histogram diff with unchanged "
        "kernels and collectives. `--update-snapshots --device cpu` "
        "regenerates after INTENDED changes; the diff in the commit is "
        "the review surface.")

    def check_snapshot(self, report: TraceReport,
                       snapshot: dict | None) -> Iterable[Diagnostic]:
        fp = fingerprint(report)
        if snapshot is None:
            yield _diag(
                self, report,
                "no golden snapshot for this program/case; run "
                "`--update-snapshots --device cpu` and commit "
                "kepltorch.json")
            return
        for field in sorted(set(fp) | set(snapshot)):
            got, want = fp.get(field), snapshot.get(field)
            if got != want:
                yield _diag(
                    self, report,
                    f"fingerprint drift in `{field}`: snapshot "
                    f"{_compact(want)} != traced {_compact(got)} — "
                    f"intended? regenerate with `--update-snapshots "
                    f"--device cpu` and review the diff")


def _compact(value: object, limit: int = 160) -> str:
    text = json.dumps(value, sort_keys=True, default=str)
    return text if len(text) <= limit else text[:limit] + "…"


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------


def snapshot_path(root: str) -> str:
    return os.path.join(root, SNAPSHOT_NAME)


def load_snapshots(root: str) -> dict[str, dict] | None:
    path = snapshot_path(root)
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except OSError:
        return None
    if not isinstance(data, dict) or data.get("version") != SNAPSHOT_VERSION:
        raise ValueError(f"unsupported snapshot file {path!r}")
    programs = data.get("programs", {})
    if not isinstance(programs, dict):
        raise ValueError(f"malformed snapshot file {path!r}")
    return programs


def trace_all(specs: tuple[ProgramSpec, ...] = DEVICE_PROGRAMS,
              device: str = "cuda") -> tuple[
        list[TraceReport], list[Diagnostic]]:
    """Run every case of ``specs`` on ``device`` (cached) → (reports,
    build/run failures as KTL000)."""
    from kepler_tpu_torch.analysis.device.trace import trace_case

    reports: list[TraceReport] = []
    errors: list[Diagnostic] = []
    for spec in specs:
        for case in spec.cases:
            key = (spec.name, case.name, device)
            report = _TRACE_CACHE.get(key)
            if report is None:
                try:
                    report = trace_case(spec, case, device)
                except Exception as err:  # a failed run is a finding
                    errors.append(Diagnostic(
                        path=spec.source, line=1, col=1,
                        rule_id="KTL000", severity=SEVERITY_ERROR,
                        message=f"[{spec.name}/{case.name}] device "
                                f"program failed to build/run: "
                                f"{type(err).__name__}: "
                                f"{str(err)[:200]}"))
                    continue
                _TRACE_CACHE[key] = report
            reports.append(report)
    return reports, errors


def write_snapshots(root: str,
                    specs: tuple[ProgramSpec, ...] = DEVICE_PROGRAMS,
                    device: str = "cuda",
                    ) -> tuple[int, list[Diagnostic]]:
    """Regenerate the snapshot file from live runs → (count, errors)."""
    import torch

    reports, errors = trace_all(specs, device)
    payload = {
        "version": SNAPSHOT_VERSION,
        "comment": "the port's golden program fingerprints (KTL123): "
                   "normalized op structure per registry entry/case. "
                   "Regenerate with `python -m kepler_tpu_torch.analysis "
                   "--update-snapshots --device cpu` after an INTENDED "
                   "program change; review the diff. Never edit by hand.",
        "torch": torch.__version__.split("+")[0],
        "programs": {r.key: fingerprint(r)
                     for r in sorted(reports, key=lambda r: r.key)},
    }
    path = snapshot_path(root)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")
    return len(reports), errors


def analyze_device_programs(
        root: str,
        only: set[str] | None = None,
        specs: tuple[ProgramSpec, ...] = DEVICE_PROGRAMS,
        device: str = "cuda",
) -> list[Diagnostic]:
    """Run every registry case on ``device`` and run the device-tier
    families over the recorded runs.

    ``only`` restricts to a subset of rule ids (the CLI's ``--only``);
    build/run failures always report (as KTL000).
    """
    from kepler_tpu_torch.analysis.engine import REGISTRY

    def want(rule_id: str) -> bool:
        return only is None or rule_id in only

    reports, diags = trace_all(specs, device)
    trace_rules = [REGISTRY[rid] for rid in ("KTL120", "KTL121", "KTL122")
                   if want(rid)]
    for report in reports:
        for rule in trace_rules:
            diags.extend(rule.check_trace(report))
    if want("KTL123"):
        ratchet = REGISTRY["KTL123"]
        try:
            snapshots = load_snapshots(root)
        except ValueError as err:
            diags.append(Diagnostic(
                path=SNAPSHOT_NAME, line=1, col=1, rule_id="KTL123",
                severity=SEVERITY_ERROR, message=str(err)))
            snapshots = {}
        if snapshots is None:
            diags.append(Diagnostic(
                path=SNAPSHOT_NAME, line=1, col=1, rule_id="KTL123",
                severity=SEVERITY_ERROR,
                message=f"missing {SNAPSHOT_NAME}; generate the golden "
                        f"program snapshots with `--update-snapshots "
                        f"--device cpu` and commit them"))
        else:
            for report in reports:
                diags.extend(ratchet.check_snapshot(
                    report, snapshots.get(report.key)))
            live = {r.key for r in reports}
            wanted_specs = {s.name for s in specs}
            registered = {s.name for s in DEVICE_PROGRAMS}
            for key in sorted(snapshots):
                spec_name = key.rsplit("/", 1)[0]
                # a snapshot key is stale when its case disappeared from
                # an analyzed spec, OR its whole spec left the registry
                # (a test analyzing a specs SUBSET must not false-flag
                # the other still-registered programs' entries)
                if key not in live and (spec_name in wanted_specs
                                        or spec_name not in registered):
                    diags.append(Diagnostic(
                        path=SNAPSHOT_NAME, line=1, col=1,
                        rule_id="KTL123", severity=SEVERITY_ERROR,
                        message=f"stale snapshot entry {key!r} (program/"
                                f"case no longer registered); regenerate "
                                f"with `--update-snapshots --device cpu`"))
    return sorted(diags)
