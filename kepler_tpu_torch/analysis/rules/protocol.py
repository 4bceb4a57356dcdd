"""KTL133 — protocol-transition marker discipline (lexical tier).

kepmc (``kepler_tpu_torch/analysis/protocol``) model-checks the fleet's
protocol state machines by driving the SAME pure functions production
runs. That equivalence only holds while every mutation of protocol
state — lease epochs/holders, seq watermarks, spool ack cursors,
wire-v2 base rows — goes through a function declared as a transition.
KTL133 is the fence: inside ``kepler_tpu_torch/fleet/``, an assignment to a
protected protocol attribute is only legal inside a function marked
``# keplint: protocol-transition`` (on the def line, a decorator line,
or the contiguous comment block above — markers stack with
requires-lock and friends). ``__init__`` is not exempt: birth states
are transitions too, and the shipped ones carry the marker.

An unmarked write site is exactly a transition the model checker does
not know about — the KTL130-132 all-clear would silently stop covering
it.
"""

from __future__ import annotations

import ast
from typing import Iterable, Iterator

from kepler_tpu_torch.analysis.engine import (
    Diagnostic,
    FileContext,
    Rule,
    SCOPED_TREES,
    register,
)

MARKER = "protocol-transition"

#: the protocol-state attribute surface kepmc models. An attribute
#: lands here when a KTL130-132 model's transition rules read or move
#: it; renaming one in fleet code must update this set AND the model.
PROTECTED_ATTRS = frozenset({
    # lease / membership (lease.succession, lease.partitioned)
    "_epoch", "_holder", "_ring_epoch",
    # seq tracker watermarks (seq.delivery)
    "max_seen", "ring_epoch",
    # spool durability cursor (spool.cursor)
    "_cursor_seg", "_cursor_off", "_acked_through",
    # wire-v2 base-row machine (keyframe.delta)
    "_kf_base", "_needs_keyframe", "_since_keyframe", "_base_rows",
})


def _target_attrs(target: ast.expr) -> Iterator[ast.Attribute]:
    """Attribute nodes a store-target actually writes: unwraps tuple/
    list unpacking, starred targets and subscript chains (``x.a[k] =``
    writes through ``x.a``), without descending into index/value
    expressions (those are reads)."""
    if isinstance(target, (ast.Tuple, ast.List)):
        for el in target.elts:
            yield from _target_attrs(el)
        return
    if isinstance(target, ast.Starred):
        yield from _target_attrs(target.value)
        return
    node: ast.expr = target
    while isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute):
        yield node


@register
class ProtocolTransitionMarkerRule(Rule):
    id = "KTL133"
    name = "protocol-transition-marker"
    summary = ("inside kepler_tpu_torch/fleet/, protocol state (epoch/seq/"
               "ack/base-row attributes) is only written inside "
               "functions marked `# keplint: protocol-transition`")
    rationale = (
        "The kepmc protocol tier (KTL130-132) proves safety by "
        "exhaustively exploring models built from the fleet's pure "
        "transition functions — and that proof covers production "
        "exactly as long as production state only moves THROUGH those "
        "functions. This rule makes the boundary machine-checkable: "
        "every assignment to a protected protocol attribute (lease "
        "epoch/holder, ring epoch, seq watermark, spool cursor, "
        "keyframe base state) must sit inside a function carrying the "
        "`# keplint: protocol-transition` marker. A write outside a "
        "marked function is a transition the model checker cannot "
        "see: the KTL130-132 all-clear would silently stop meaning "
        "anything for that code path. Birth states (__init__) are "
        "marked, not exempted — initialization chooses the protocol's "
        "initial state, and the models start from it.")

    def in_scope(self, rel_path: str) -> bool:
        head = rel_path.split("/", 1)[0]
        if head not in SCOPED_TREES:
            return True  # explicitly linted fixtures get the rule
        return rel_path.startswith("kepler_tpu_torch/fleet/")

    def check(self, ctx: FileContext) -> Iterable[Diagnostic]:
        yield from self._walk(ctx, ctx.tree.body, marked=False,
                              where="module level")

    def _walk(self, ctx: FileContext, body: list, marked: bool,
              where: str) -> Iterator[Diagnostic]:
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # a nested def runs later, outside the enclosing
                # transition — it needs its own marker
                fn_marked = ctx.marker_on(node, MARKER) is not None
                yield from self._walk(ctx, node.body, fn_marked,
                                      f"{node.name}()")
                continue
            if isinstance(node, ast.ClassDef):
                yield from self._walk(ctx, node.body, False, where)
                continue
            yield from self._check_stmt(ctx, node, marked, where)
            for attr in ("body", "orelse", "finalbody"):
                child = getattr(node, attr, None)
                if child:
                    yield from self._walk(ctx, child, marked, where)
            for handler in getattr(node, "handlers", []) or []:
                yield from self._walk(ctx, handler.body, marked, where)

    def _check_stmt(self, ctx: FileContext, node: ast.AST, marked: bool,
                    where: str) -> Iterator[Diagnostic]:
        if marked:
            return
        targets: list[ast.expr] = []
        if isinstance(node, ast.Assign):
            targets = list(node.targets)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        for target in targets:
            for attr_node in _target_attrs(target):
                if attr_node.attr not in PROTECTED_ATTRS:
                    continue
                yield ctx.diag(
                    self, node,
                    f"write to protocol state `.{attr_node.attr}` in "
                    f"{where} outside a `# keplint: {MARKER}`-marked "
                    f"function — kepmc (KTL130-132) only proves "
                    f"schedules over declared transitions; mark the "
                    f"function (and cover it in the model) or move the "
                    f"write into an existing transition")
