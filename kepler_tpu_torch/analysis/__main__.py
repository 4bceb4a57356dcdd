"""keplint CLI for the port: ``python -m kepler_tpu_torch.analysis [paths]``.

Exit codes: 0 clean (baselined violations and stale-baseline notices do
not fail), 1 new error-severity findings, 2 usage errors. The default
trees are ``kepler_tpu_torch`` and ``chip_smoke.py`` under the repo root
(the directory holding pyproject.toml, walked up from the first path).
The default baseline is the port's own, ``kepler_tpu_torch/analysis/
keplint.json``; the root ``.keplint.json`` belongs to the reference
package and is never read.

``--format`` selects the report shape: ``text`` (default, one line per
finding), ``json`` (machine-readable summary), or ``sarif`` (SARIF
2.1.0 minimal profile, consumable as CI annotations). ``--per-file``
restricts the whole-program rules (KTL111-113) to single-file contexts:
cross-module findings disappear, which is useful for bisecting whether
a finding needs the call graph.

``--device-tier`` additionally runs the registered device programs
(``kepler_tpu_torch/analysis/device``) once each, at tiny shapes under
an op recorder, and runs the KTL120-123 families over what they did —
seconds of cost, so it is opt-in. The programs run on ``--device``
(``cuda`` by default; the tier exits 1 naming CUDA when no card is
visible, and the CPU runs only with ``--device cpu``).
``--update-snapshots`` regenerates the KTL123 golden fingerprints
(``kepler_tpu_torch/analysis/device/kepltorch.json``) and exits.
``--only=KTL110,KTL120`` restricts a run to the named rules.

``--protocol-tier`` exhaustively explores the registered protocol
models (``kepler_tpu_torch/analysis/protocol``, the kepmc checker) over
the port's fleet functions and runs the KTL130-132 families over their
reachable state spaces. Naming a KTL13x id in ``--only`` implies the
tier. KTL133 (the protocol-transition marker fence) is an ordinary
per-file rule and always runs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Sequence

from kepler_tpu_torch.analysis.engine import (
    Baseline,
    Diagnostic,
    LintResult,
    SEVERITY_ERROR,
    all_rules,
    find_repo_root,
    lint_paths,
)

BASELINE_NAME = "kepler_tpu_torch/analysis/keplint.json"
# default lint surface: the port and the script that drives it on the card
DEFAULT_TREES = ("kepler_tpu_torch", "chip_smoke.py")

SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                "master/Schemata/sarif-schema-2.1.0.json")


def main(argv: Sequence[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m kepler_tpu_torch.analysis",
        description="keplint: AST invariant checks for the port of the "
                    "attribution stack, its protocol models and its "
                    "device programs")
    parser.add_argument("paths", nargs="*", default=None,
                        help="files/directories to lint (default: "
                             "kepler_tpu_torch and chip_smoke.py under the "
                             "repo root)")
    parser.add_argument("--baseline", default=None,
                        help=f"baseline file (default: <root>/"
                             f"{BASELINE_NAME} when present)")
    parser.add_argument("--no-baseline", action="store_true",
                        help="ignore any baseline file")
    parser.add_argument("--write-baseline", action="store_true",
                        help="freeze current violations into the "
                             "baseline and exit 0")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule registry and exit")
    parser.add_argument("--format", choices=("text", "json", "sarif"),
                        default="text",
                        help="report format (default: text)")
    parser.add_argument("--per-file", action="store_true",
                        help="restrict whole-program rules (KTL111-113) "
                             "to single-file contexts — no cross-module "
                             "call graph")
    parser.add_argument("--device-tier", action="store_true",
                        help="also run the registered device programs "
                             "under the op recorder and run the KTL120-123 "
                             "checks")
    parser.add_argument("--device", choices=("cuda", "cpu"),
                        default="cuda",
                        help="where the device tier runs its programs "
                             "(default: cuda; exits 1 without a card)")
    parser.add_argument("--update-snapshots", action="store_true",
                        help="regenerate the KTL123 golden program "
                             "fingerprints (kepltorch.json) and exit")
    parser.add_argument("--protocol-tier", action="store_true",
                        help="also explore the registered protocol "
                             "models (kepmc) and run the KTL130-132 "
                             "state-space checks")
    parser.add_argument("--only", default=None, metavar="KTLxxx[,KTLxxx]",
                        help="run only the named rules; naming a KTL12x "
                             "id implies --device-tier, a KTL130-132 id "
                             "implies --protocol-tier")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in all_rules():
            print(f"{rule.id}  {rule.name:<20} [{rule.severity}] "
                  f"{rule.summary}")
        return 0

    only_ids: set[str] | None = None
    if args.only:
        only_ids = {p.strip() for p in args.only.split(",") if p.strip()}
        known = {r.id for r in all_rules()}
        unknown = only_ids - known
        if unknown:
            print(f"keplint: unknown rule id(s) in --only: "
                  f"{', '.join(sorted(unknown))}", file=sys.stderr)
            return 2

    root = find_repo_root(args.paths[0] if args.paths else os.getcwd())
    if args.paths:
        paths = args.paths
    else:
        paths = [os.path.join(root, tree) for tree in DEFAULT_TREES
                 if os.path.exists(os.path.join(root, tree))]
    for path in paths:
        if not os.path.exists(path):
            print(f"keplint: no such path: {path}", file=sys.stderr)
            return 2

    device_ids = {"KTL120", "KTL121", "KTL122", "KTL123"}
    protocol_ids = {"KTL130", "KTL131", "KTL132"}
    if only_ids is None:
        device_wanted = args.device_tier
        protocol_wanted = args.protocol_tier
    else:
        device_wanted = bool(only_ids & device_ids)
        protocol_wanted = bool(only_ids & protocol_ids)
    if device_wanted or args.update_snapshots:
        from kepler_tpu_torch.device import resolve_device

        try:
            resolve_device(args.device)
        except RuntimeError as err:
            print(f"keplint: {err}", file=sys.stderr)
            return 1

    if args.update_snapshots:
        from kepler_tpu_torch.analysis.device import (SNAPSHOT_NAME,
                                                      write_snapshots)

        count, errors = write_snapshots(root, device=args.device)
        for diag in errors:
            print(diag.render(), file=sys.stderr)
        print(f"keplint: wrote {os.path.join(root, SNAPSHOT_NAME)} "
              f"({count} program fingerprint(s))")
        return 1 if errors else 0

    baseline_path = args.baseline or os.path.join(root, BASELINE_NAME)
    baseline: Baseline | None = None
    if not args.no_baseline and not args.write_baseline:
        if os.path.exists(baseline_path):
            try:
                baseline = Baseline.load(baseline_path)
            except (OSError, ValueError) as err:
                print(f"keplint: bad baseline {baseline_path}: {err}",
                      file=sys.stderr)
                return 2

    rules = all_rules()
    if only_ids is not None:
        rules = [r for r in rules if r.id in only_ids]
    # --only with a device-rule id implies the device tier (see above):
    # silently skipping the only rules the user named (and printing
    # "clean") would be a false all-clear

    def run_lint() -> LintResult:
        result = lint_paths(paths, root=root, rules=rules,
                            per_file=args.per_file)
        if device_wanted:
            from kepler_tpu_torch.analysis.device import (
                analyze_device_programs)

            result.diagnostics.extend(analyze_device_programs(
                root, only=only_ids, device=args.device))
            result.diagnostics.sort()
        if protocol_wanted:
            from kepler_tpu_torch.analysis.protocol import (
                analyze_protocol_specs)

            result.diagnostics.extend(
                analyze_protocol_specs(root, only=only_ids))
            result.diagnostics.sort()
        return result

    if args.write_baseline:
        full = run_lint()
        Baseline.from_diagnostics(full.diagnostics).save(baseline_path)
        print(f"keplint: wrote {baseline_path} "
              f"({len(full.diagnostics)} frozen violation(s))")
        return 0

    result = run_lint()
    if baseline is not None:
        result = baseline.apply(result.diagnostics)
    if args.format == "sarif":
        print(json.dumps(render_sarif(result), indent=2))
        return 1 if result.failed else 0
    if args.format == "json":
        print(json.dumps(render_json(result), indent=2))
        return 1 if result.failed else 0
    return report(result)


def report(result: LintResult) -> int:
    for diag in result.diagnostics:
        print(diag.render())
    if result.stale_entries:
        print("keplint: stale baseline entries (violations fixed — "
              "regenerate with --write-baseline to ratchet down):",
              file=sys.stderr)
        for key in result.stale_entries:
            print(f"  {key}", file=sys.stderr)
    if result.diagnostics:
        n = len(result.diagnostics)
        suffix = (f" ({result.baselined} more baselined)"
                  if result.baselined else "")
        print(f"keplint: {n} new violation(s){suffix}", file=sys.stderr)
        return 1 if result.failed else 0
    extra = (f" ({result.baselined} baselined violation(s) tolerated)"
             if result.baselined else "")
    print(f"keplint: clean{extra}")
    return 0


def render_json(result: LintResult) -> dict:
    return {
        "violations": [
            {"path": d.path, "line": d.line, "col": d.col,
             "rule": d.rule_id, "severity": d.severity,
             "message": d.message}
            for d in result.diagnostics],
        "baselined": result.baselined,
        "stale_baseline_entries": list(result.stale_entries),
        "failed": result.failed,
    }


def render_sarif(result: LintResult) -> dict:
    """SARIF 2.1.0 minimal profile: one run, the rule catalog as
    reportingDescriptors, one result per diagnostic with a physical
    location (CI annotation shape)."""
    rules = all_rules()
    rule_index = {r.id: i for i, r in enumerate(rules)}
    results = []
    for d in result.diagnostics:
        results.append({
            "ruleId": d.rule_id,
            "ruleIndex": rule_index.get(d.rule_id, -1),
            "level": ("error" if d.severity == SEVERITY_ERROR
                      else "warning"),
            "message": {"text": d.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {
                        "uri": d.path,
                        "uriBaseId": "SRCROOT",
                    },
                    "region": {
                        "startLine": d.line,
                        "startColumn": d.col,
                    },
                },
            }],
        })
    driver = {
        "name": "keplint",
        "informationUri": ("https://github.com/sustainable-computing-io/"
                           "kepler"),
        "rules": [{
            "id": r.id,
            "name": r.name,
            "shortDescription": {"text": r.summary},
            "fullDescription": {"text": r.rationale},
            "defaultConfiguration": {
                "level": ("error" if r.severity == SEVERITY_ERROR
                          else "warning"),
            },
        } for r in rules],
    }
    return {
        "$schema": SARIF_SCHEMA,
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": driver},
            "results": results,
        }],
    }


if __name__ == "__main__":
    sys.exit(main())
