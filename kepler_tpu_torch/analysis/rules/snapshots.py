"""KTL103 — published snapshots stay immutable."""

from __future__ import annotations

import ast
from typing import Iterable

from kepler_tpu_torch.analysis.engine import Diagnostic, FileContext, Rule, register
from kepler_tpu_torch.analysis.rules.common import qualname

# distinctive Snapshot/NodeUsage/WorkloadTable field names; generic ones
# (ids/meta/node/...) are omitted so unrelated objects don't false-positive
_SNAPSHOT_FIELDS = frozenset({
    "energy_uj", "active_uj", "idle_uj",
    "power_uw", "active_power_uw", "idle_power_uw",
    "window_active_uj", "zone_names",
    "terminated_processes", "terminated_containers",
    "terminated_virtual_machines", "terminated_pods",
})

# the monitor build path constructs snapshots before publication
_SNAPSHOT_BUILDER_SUFFIXES = (
    "kepler_tpu_torch/monitor/monitor.py",
    "kepler_tpu_torch/monitor/snapshot.py",
)


@register
class SnapshotImmutableRule(Rule):
    id = "KTL103"
    name = "snapshot-immutable"
    summary = "no mutation of Snapshot fields outside the monitor build path"
    rationale = (
        "`PowerMonitor.snapshot(clone=False)` hands consumers the "
        "published object itself; the exporter's zero-copy scrape render "
        "is only race-free because a published Snapshot is never mutated "
        "— each refresh builds new arrays and swaps the reference. The "
        "dataclasses are frozen, but numpy array *contents* are not, so "
        "`snap.node.energy_uj[0] = x` (or `object.__setattr__`) would "
        "corrupt concurrent scrapes silently.")

    def check(self, ctx: FileContext) -> Iterable[Diagnostic]:
        if ctx.rel_path.endswith(_SNAPSHOT_BUILDER_SUFFIXES):
            return
        for node in ctx.walk_nodes:
            if isinstance(node, ast.Call):
                canon = qualname(node.func)
                if canon == "object.__setattr__":
                    yield ctx.diag(
                        self, node,
                        "object.__setattr__ defeats frozen-dataclass "
                        "immutability; build a new Snapshot instead")
                continue
            targets: list[ast.expr] = []
            if isinstance(node, ast.Assign):
                targets = list(node.targets)
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = [node.target]
            for target in targets:
                # unwrap element writes: snap.node.energy_uj[...] = v
                inner = target
                while isinstance(inner, ast.Subscript):
                    inner = inner.value
                if not isinstance(inner, ast.Attribute):
                    continue
                if inner.attr not in _SNAPSHOT_FIELDS:
                    continue
                # only a DIRECT `self.<field>` write is own state (the
                # monitor-style accumulator); a deeper chain rooted at
                # self (`self._snap.node.energy_uj[...]`) is a held
                # published snapshot and exactly the bug class
                if (isinstance(inner.value, ast.Name)
                        and inner.value.id == "self"):
                    continue
                yield ctx.diag(
                    self, node,
                    f"mutation of snapshot field {inner.attr!r} outside "
                    "the monitor build path; published snapshots are "
                    "immutable — build new arrays and swap the reference")
