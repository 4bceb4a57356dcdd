"""KTL105 — Prometheus metric naming."""

from __future__ import annotations

import ast
import re
from typing import Iterable

from kepler_tpu_torch.analysis.engine import Diagnostic, FileContext, Rule, register
from kepler_tpu_torch.analysis.rules.common import qualname, terminal

_METRIC_CTORS = {
    "CounterMetricFamily", "GaugeMetricFamily", "HistogramMetricFamily",
    "SummaryMetricFamily", "InfoMetricFamily", "UntypedMetricFamily",
    "Counter", "Gauge", "Histogram", "Summary", "Info", "Enum",
}
_METRIC_NAME = re.compile(r"^kepler_[a-z][a-z0-9_]*$")
# approved final name tokens: units first, then semantic/count forms
_UNIT_TOKENS = frozenset({
    "total", "joules", "watts", "seconds", "ratio", "ms", "bytes",
    "celsius", "info", "healthy", "degraded", "flops", "state",
    "epoch", "version",
})
_COUNT_TOKENS = frozenset({"nodes", "workloads", "records", "rows",
                           "shards", "windows", "inflight",
                           # elastic membership: ring
                           # replicas are counted, not measured
                           "peers", "replicas"})
# reference-parity names grandfathered in (match the upstream exporter)
_EXACT_ALLOW = frozenset({"kepler_node_cpu_power_meter"})


def _metric_name_literal(arg: ast.expr) -> tuple[str | None, str | None]:
    """(full_constant_name, trailing_literal) for the first ctor arg.

    f-strings return (None, trailing-literal-if-any): the charset of the
    dynamic part can't be checked, but the unit suffix usually can.
    """
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        if not arg.value.startswith("kepler_"):
            return None, None  # another namespace: out of scope
        return arg.value, arg.value
    if isinstance(arg, ast.JoinedStr) and arg.values:
        first = arg.values[0]
        if not (isinstance(first, ast.Constant)
                and isinstance(first.value, str)
                and first.value.startswith("kepler_")):
            return None, None
        last = arg.values[-1]
        if isinstance(last, ast.Constant) and isinstance(last.value, str):
            return None, last.value
        return None, ""  # dynamic tail: unverifiable
    return None, None


@register
class MetricNameRule(Rule):
    id = "KTL105"
    name = "metric-name"
    summary = ("metric names match `kepler_[a-z0-9_]+` and end with a "
               "unit suffix; counters end `_total`")
    rationale = (
        "Dashboards and recording rules key on metric names; drift "
        "(`kepler_fleet_reports` vs `..._total`) silently splits series "
        "across versions. prometheus_client appends `_total` to counter "
        "samples regardless of the declared family name, so a counter "
        "declared without it exposes a name that exists nowhere in the "
        "source — grep-proofing requires declaring the exposed name. "
        "Scope includes hack/ and benchmarks/: bench rows and tooling "
        "emit `kepler_*` names that dashboards join against the "
        "production series, so they obey the same grammar.")
    tree_scope = ("kepler_tpu_torch", "hack", "benchmarks")

    def check(self, ctx: FileContext) -> Iterable[Diagnostic]:
        for node in ctx.walk_nodes:
            if not (isinstance(node, ast.Call) and node.args):
                continue
            ctor = terminal(qualname(node.func))
            if ctor not in _METRIC_CTORS:
                continue
            full, tail = _metric_name_literal(node.args[0])
            if full is None and tail is None:
                continue  # not a kepler metric literal
            shown = full if full is not None else f"…{tail}"
            if full is not None:
                if full in _EXACT_ALLOW:
                    continue
                if not _METRIC_NAME.match(full):
                    yield ctx.diag(
                        self, node,
                        f"metric name {full!r} must match "
                        "kepler_[a-z][a-z0-9_]*")
                    continue
            is_counter = ctor.startswith("Counter")
            if is_counter:
                if tail is not None and not tail.endswith("_total"):
                    yield ctx.diag(
                        self, node,
                        f"counter {shown!r} must be declared with the "
                        "exposed `_total` suffix")
                continue
            if tail is None or not tail:
                continue  # dynamic tail: cannot verify the suffix
            token = tail.rsplit("_", 1)[-1]
            if token not in _UNIT_TOKENS and token not in _COUNT_TOKENS:
                yield ctx.diag(
                    self, node,
                    f"metric {shown!r} lacks a recognized unit suffix "
                    f"(one of {', '.join(sorted(_UNIT_TOKENS))} or a "
                    "count noun); name the unit or extend the rule's "
                    "token set deliberately")
