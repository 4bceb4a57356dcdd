"""KTL106 — no blocking I/O in the refresh hot loop (lexical tier).

The call-graph-aware generalization (blocking calls *reachable* from a
hot-loop root through any chain) is KTL113 in ``roles.py``; this rule
stays as the fast intra-file tier that needs no project build.
"""

from __future__ import annotations

import ast
from typing import Iterable

from kepler_tpu_torch.analysis.engine import Diagnostic, FileContext, Rule, register
from kepler_tpu_torch.analysis.rules.common import imports_for, is_blocking_call


@register
class HotLoopBlockingRule(Rule):
    id = "KTL106"
    name = "hot-loop-blocking"
    summary = ("no sleep / blocking I/O inside functions marked "
               "`# keplint: hot-loop`")
    rationale = (
        "The monitor's refresh loop runs under the snapshot lock on the "
        "interval cadence; one stray sleep or network call inside it "
        "stalls every scrape and window listener and eventually trips "
        "the watchdog. Functions on the refresh path carry `# keplint: "
        "hot-loop`; the check is lexical (direct calls only) — KTL113 "
        "extends it through the call graph, and seams like the meter "
        "keep their own contracts.")

    def check(self, ctx: FileContext) -> Iterable[Diagnostic]:
        imports = imports_for(ctx)
        for node in ctx.walk_nodes:
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            if ctx.marker_on(node, "hot-loop") is None:
                continue
            for call in ast.walk(node):
                if not isinstance(call, ast.Call):
                    continue
                canon = is_blocking_call(call, imports)
                if canon:
                    yield ctx.diag(
                        self, call,
                        f"blocking call {canon}() inside hot-loop "
                        f"function {node.name}(); the refresh path must "
                        "not sleep or do I/O beyond the meter seam")
