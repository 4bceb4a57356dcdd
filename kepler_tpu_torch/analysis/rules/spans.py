"""KTL109 — telemetry span discipline."""

from __future__ import annotations

import ast
from typing import Iterable, Iterator

from kepler_tpu_torch.analysis.engine import Diagnostic, FileContext, Rule, register
from kepler_tpu_torch.analysis.rules.common import (
    Imports,
    WALL_CLOCK_CALLS,
    call_canonical,
    imports_for,
    jitted_functions,
    terminal,
)


def _is_span_call(node: ast.AST, imports: Imports) -> bool:
    """A call to the telemetry span API: ``telemetry.span(...)`` (module
    import), ``kepler_tpu_torch.telemetry.span`` (canonicalized from-import),
    or a bare ``span(...)`` whose import resolves into the telemetry
    package."""
    if not isinstance(node, ast.Call):
        return False
    canon = call_canonical(node, imports) or ""
    if terminal(canon) != "span":
        return False
    return canon == "span" or canon.endswith("telemetry.span")


def _walk_span_body(node: ast.AST) -> Iterator[ast.AST]:
    """Walk a span with-block like ``ast.walk`` but WITHOUT descending
    into nested function/lambda definitions: a callback defined inside
    the body runs after the span closed, so its clock calls are not
    span-body timing."""
    stack: list[ast.AST] = list(ast.iter_child_nodes(node))
    while stack:
        child = stack.pop()
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
            continue
        yield child
        stack.extend(ast.iter_child_nodes(child))


@register
class SpanDisciplineRule(Rule):
    id = "KTL109"
    name = "span-discipline"
    summary = ("span bodies use monotonic clocks only, and span() never "
               "appears inside kernel wrappers or their plain versions")
    rationale = (
        "Telemetry spans time their body with `time.monotonic`; a wall-"
        "clock call (`time.time`, `datetime.now`) inside a `with "
        "span(...)` body means the stage's own logic is deriving "
        "durations from a clock NTP can step — the histogram and the "
        "code would disagree about what was measured. (The injected "
        "`self._clock` seam stays legal: seams are the sanctioned wall-"
        "clock source.) And a kernel launch is asynchronous, so a span "
        "inside a kernel wrapper times the host's enqueue, not the "
        "kernel, and a span inside its plain version times the CPU "
        "stand-in — either sample would be read as device time "
        "(composes with KTL107's purity rule).")

    def check(self, ctx: FileContext) -> Iterable[Diagnostic]:
        imports = imports_for(ctx)
        # part 1: wall-clock calls inside `with span(...)` bodies
        for node in ctx.walk_nodes:
            if not isinstance(node, ast.With):
                continue
            if not any(_is_span_call(item.context_expr, imports)
                       for item in node.items):
                continue
            for call in _walk_span_body(node):
                if not isinstance(call, ast.Call):
                    continue
                canon = call_canonical(call, imports)
                if canon in WALL_CLOCK_CALLS:
                    yield ctx.diag(
                        self, call,
                        f"wall-clock call {canon}() inside a telemetry "
                        "span body; spans time with time.monotonic — "
                        "use the monotonic clock or an injected seam")
        # part 2: span() inside kernel wrappers / plain versions
        for fn in jitted_functions(ctx):
            for call in ast.walk(fn):
                if _is_span_call(call, imports):
                    yield ctx.diag(
                        self, call,
                        f"telemetry span inside kernel function "
                        f"{fn.name}(); it would time the enqueue or the "
                        "CPU stand-in — instrument the call site, not the "
                        "kernel")
