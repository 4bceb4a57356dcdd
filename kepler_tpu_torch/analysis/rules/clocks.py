"""KTL101 — monotonic clocks in timing logic."""

from __future__ import annotations

import ast
from typing import Iterable

from kepler_tpu_torch.analysis.engine import Diagnostic, FileContext, Rule, register
from kepler_tpu_torch.analysis.rules.common import (
    WALL_CLOCK_CALLS,
    call_canonical,
    imports_for,
)


@register
class MonotonicClockRule(Rule):
    id = "KTL101"
    name = "monotonic-clock"
    summary = ("no wall-clock calls in modules marked "
               "`# keplint: monotonic-only`")
    rationale = (
        "Backoff, rate-limit, circuit-breaker, and watchdog arithmetic "
        "breaks when NTP steps the wall clock (a bug class once "
        "fixed by hand). Timing modules declare `# keplint: "
        "monotonic-only` and may then only *call* `time.monotonic()` or "
        "an injected clock seam; referencing `time.time` as an injectable "
        "default stays legal because the seam is the point. Scope "
        "includes hack/ and benchmarks/: bench timing math breaks the "
        "same way production timing math does.")
    tree_scope = ("kepler_tpu_torch", "hack", "benchmarks")

    def check(self, ctx: FileContext) -> Iterable[Diagnostic]:
        if not ctx.has_file_marker("monotonic-only"):
            return
        imports = imports_for(ctx)
        for node in ctx.walk_nodes:
            if not isinstance(node, ast.Call):
                continue
            canon = call_canonical(node, imports)
            if canon in WALL_CLOCK_CALLS:
                yield ctx.diag(
                    self, node,
                    f"wall-clock call {canon}() in a monotonic-only "
                    "module; use time.monotonic() or the injected "
                    "clock/monotonic seam")
