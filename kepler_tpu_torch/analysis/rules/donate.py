"""KTL110 — arrays updated in place by a donating call are dead after it."""

from __future__ import annotations

import ast
from typing import Iterable, Iterator

from kepler_tpu_torch.analysis.engine import Diagnostic, FileContext, Rule, register
from kepler_tpu_torch.analysis.rules.common import (
    call_canonical,
    imports_for,
    qualname,
)

# the device-resident window plane: everywhere the repo donates buffers
_DONATE_SCOPE = (
    "kepler_tpu_torch/parallel/",
    "kepler_tpu_torch/fleet/aggregator.py",
    "kepler_tpu_torch/fleet/window.py",
)


def _donate_positions(node: ast.expr) -> tuple[int, ...] | None:
    """donate_argnums literal (int or tuple/list of ints) → positions."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return (node.value,)
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for elt in node.elts:
            if not (isinstance(elt, ast.Constant)
                    and isinstance(elt.value, int)
                    and not isinstance(elt.value, bool)):
                return None
            out.append(elt.value)
        return tuple(out)
    return None


def _parse_donates_arg(arg: str | None) -> tuple[int, ...] | None:
    if not arg:
        return None
    try:
        return tuple(int(p) for p in arg.split(","))
    except ValueError:
        return None


@register
class DonatedBufferRule(Rule):
    id = "KTL110"
    name = "donated-dead"
    summary = ("arrays passed at a donated position are dead after the "
               "call — rebind (`x = f(x, …)`) or never touch them again")
    rationale = (
        "The port's window programs take the resident fleet batch and "
        "update it IN PLACE (the scatter of a window's delta rows, the "
        "fused K-window flush) — its form of the reference's "
        "`donate_argnums`. A name that aliased the batch before the call "
        "reads the POST-call values after it: a read meant as the old "
        "state (a rollback copy, a before/after comparison, a second "
        "shard's view) silently observes the new one. The check is "
        "LEXICAL, scoped to the window plane (kepler_tpu_torch/parallel/, "
        "fleet/aggregator.py, fleet/window.py): a callable whose binding "
        "carries `# keplint: donates=<pos>` (or one bound from a "
        "`jit(..., donate_argnums=…)` call) consumes the variables at "
        "those positions; any later read before a rebinding is flagged. "
        "The canonical legal shape is `resident = update(resident, …)`, "
        "or no further read of the name at all.")

    def check(self, ctx: FileContext) -> Iterable[Diagnostic]:
        if not ctx.rel_path.startswith(_DONATE_SCOPE):
            return
        donators = self._donating_aliases(ctx)
        for node in ctx.walk_nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._check_function(ctx, node, donators)

    def _donating_aliases(self, ctx: FileContext) -> dict[str,
                                                          tuple[int, ...]]:
        """qualname (``update`` / ``self._update``) → donated positions,
        from `jax.jit(..., donate_argnums=…)` bindings and `donates=`
        directives anywhere in the file."""
        imports = imports_for(ctx)
        out: dict[str, tuple[int, ...]] = {}
        for node in ctx.walk_nodes:
            if not isinstance(node, ast.Assign):
                continue
            positions: tuple[int, ...] | None = None
            value = node.value
            if isinstance(value, ast.Call):
                canon = call_canonical(value, imports) or ""
                if canon in ("jax.jit", "jit") or canon.endswith(".jit"):
                    for kw in value.keywords:
                        if kw.arg == "donate_argnums":
                            positions = _donate_positions(kw.value)
            for kind, arg in ctx.directives.get(node.lineno, []):
                if kind == "donates":
                    positions = _parse_donates_arg(arg) or positions
            if positions is None:
                continue
            for target in node.targets:
                qual = qualname(target)
                if qual:
                    out[qual] = positions
        return out

    def _check_function(self, ctx: FileContext, fn: ast.AST,
                        donators: dict) -> Iterator[Diagnostic]:
        # consumed qualname → the line its buffer was donated on
        consumed: dict[str, int] = {}

        def statements(body):
            for stmt in body:
                yield stmt
                if isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    continue  # nested defs run later; out of scope
                for child_body in (getattr(stmt, a, None)
                                   for a in ("body", "orelse",
                                             "finalbody")):
                    if child_body:
                        yield from statements(child_body)
                for handler in getattr(stmt, "handlers", []) or []:
                    yield from statements(handler.body)
                for case in getattr(stmt, "cases", []) or []:
                    yield from statements(case.body)

        for stmt in statements(fn.body):
            diags = list(self._check_stmt(ctx, stmt, donators, consumed))
            yield from diags

    @staticmethod
    def _stmt_exprs(stmt: ast.AST) -> Iterator[ast.AST]:
        """The statement's OWN expression nodes (an If's test, a For's
        iter, an Assign's value/targets, a With's items) — nested
        statements are visited separately by the statement walk, so
        descending into them here would double-process their donations
        and falsely flag the rebind pattern inside any compound body."""
        stack = list(ast.iter_child_nodes(stmt))
        while stack:
            node = stack.pop()
            if isinstance(node, ast.stmt):
                continue
            yield node
            stack.extend(ast.iter_child_nodes(node))

    def _check_stmt(self, ctx: FileContext, stmt: ast.AST, donators: dict,
                    consumed: dict[str, int]) -> Iterator[Diagnostic]:
        # 1) reads of names consumed by an EARLIER statement
        for node in self._stmt_exprs(stmt):
            if not isinstance(node, (ast.Name, ast.Attribute)):
                continue
            if not isinstance(getattr(node, "ctx", None), ast.Load):
                continue
            qual = qualname(node)
            if qual in consumed:
                line = consumed.pop(qual)  # report once, don't cascade
                yield ctx.diag(
                    self, node,
                    f"{qual!r} was donated on line {line}: it was updated "
                    "in place and holds the post-call values; rebind "
                    "the result (`x = f(x, …)`) or stop reading it")
        # 2) donations performed by this statement
        for node in self._stmt_exprs(stmt):
            if not isinstance(node, ast.Call):
                continue
            qual = qualname(node.func)
            if qual not in donators:
                continue
            for pos in donators[qual]:
                if pos < len(node.args):
                    arg_qual = qualname(node.args[pos])
                    if arg_qual:
                        consumed[arg_qual] = node.lineno
        # 3) rebinding clears consumption (the canonical donate pattern
        #    `x = f(x, …)` lands here: consumed in (2), cleared now)
        targets: list[ast.expr] = []
        if isinstance(stmt, ast.Assign):
            targets = list(stmt.targets)
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            targets = [stmt.target]
        elif isinstance(stmt, ast.Delete):
            targets = list(stmt.targets)
        for target in targets:
            qual = qualname(target)
            if qual:
                consumed.pop(qual, None)
