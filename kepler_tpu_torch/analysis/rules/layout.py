"""KTL114 — packed row-layout offsets live in one place.

The packed fleet wire format (one f32 row: ``cpu[W] | zone[Z] |
zone_valid[Z] | ratio, denom, dt, mode``) is consumed by THREE
independent implementations that must agree bit-for-bit: the jitted
device programs, the window engines' staging path, and the pure-NumPy
rung-3 mirror (``numpy_fleet_window``). The contract is
:class:`kepler_tpu_torch.parallel.packed.PackedLayout`; this rule forbids the
signature forms of raw layout-offset arithmetic (``w + 2 * z + 1`` and
friends) in subscripts anywhere in the packed/window modules outside
the one ``# keplint: layout-definition``-marked scope, so a hand-typed
offset can never silently diverge from the contract.
"""

from __future__ import annotations

import ast
from typing import Iterable, Iterator

from kepler_tpu_torch.analysis.engine import Diagnostic, FileContext, Rule, register

# the modules that read/write packed rows or wire-frame offsets;
# everything else never sees a layout and stays out of scope
_LAYOUT_SCOPE = (
    "kepler_tpu_torch/parallel/packed.py",
    "kepler_tpu_torch/fleet/window.py",
    "kepler_tpu_torch/fleet/wire.py",
)


def _is_int_const(node: ast.AST) -> bool:
    return (isinstance(node, ast.Constant)
            and isinstance(node.value, int)
            and not isinstance(node.value, bool))


def _add_chain_terms(node: ast.expr) -> Iterator[ast.expr]:
    """Flatten a top-level ``a + b - c`` chain into its terms."""
    if isinstance(node, ast.BinOp) and isinstance(node.op,
                                                  (ast.Add, ast.Sub)):
        yield from _add_chain_terms(node.left)
        yield from _add_chain_terms(node.right)
    else:
        yield node


def _is_layout_arith(node: ast.expr) -> bool:
    """True for additive index arithmetic carrying a literal offset —
    ``w + 2 * z``, ``w + 2 * z + 1``, ``2 * z`` — the forms a packed
    column offset takes. Pure name arithmetic (``base + sb``,
    ``k * mb + len(lk)``) is row/shard indexing and stays legal."""
    terms = list(_add_chain_terms(node))
    if len(terms) < 2 and not (terms and isinstance(terms[0], ast.BinOp)):
        return False
    for term in terms:
        if _is_int_const(term):
            return True
        if isinstance(term, ast.BinOp) and isinstance(term.op, ast.Mult):
            if _is_int_const(term.left) or _is_int_const(term.right):
                return True
    return False


def _index_exprs(sl: ast.expr) -> Iterator[ast.expr]:
    """Every scalar index / slice bound inside a subscript's slice."""
    parts = sl.elts if isinstance(sl, ast.Tuple) else [sl]
    for part in parts:
        if isinstance(part, ast.Slice):
            for bound in (part.lower, part.upper, part.step):
                if bound is not None:
                    yield bound
        else:
            yield part


@register
class PackedLayoutRule(Rule):
    id = "KTL114"
    name = "packed-layout"
    summary = ("packed row/wire-frame offsets come from a "
               "`layout-definition` scope (PackedLayout, WireLayoutV2); "
               "raw additive-literal index arithmetic is forbidden "
               "outside it")
    rationale = (
        "The packed fleet row is one wire format with three independent "
        "consumers: the jitted device programs (`parallel/packed.py`), "
        "the window engines' delta-staging path (`fleet/window.py`), and "
        "the pure-NumPy rung-3 mirror (`numpy_fleet_window`) that keeps "
        "publishing when the device plane is dead. A hand-typed offset "
        "(`packed[:, w + 2 * z + 1]`) that drifts from the others is a "
        "silent mis-attribution, not a crash — the mirror would read dt "
        "where denom lives and publish plausible wrong watts. All offset "
        "arithmetic therefore lives in `PackedLayout` (the one scope "
        "marked `# keplint: layout-definition`); everywhere else in the "
        "packed/window modules, subscripts carrying additive literal "
        "offsets (`name + 2 * name + const` forms) are findings. Row and "
        "shard indexing (`base + sb`, `k * mb + len(...)`) carries no "
        "literal offsets and stays legal. The wire v2 binary frame "
        "(`fleet/wire.py`) is the same hazard one layer down — its "
        "struct offsets live in the `WireLayoutV2` "
        "`layout-definition` scope, and the encoder/decoder/restamp "
        "paths slice only through names derived from it.")

    def check(self, ctx: FileContext) -> Iterable[Diagnostic]:
        if not ctx.rel_path.startswith(_LAYOUT_SCOPE):
            return
        exempt: list[tuple[int, int]] = []
        for node in ctx.walk_nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                if ctx.marker_on(node, "layout-definition") is not None:
                    exempt.append((node.lineno,
                                   node.end_lineno or node.lineno))
        for node in ctx.walk_nodes:
            if not isinstance(node, ast.Subscript):
                continue
            if any(lo <= node.lineno <= hi for lo, hi in exempt):
                continue
            for expr in _index_exprs(node.slice):
                if _is_layout_arith(expr):
                    yield ctx.diag(
                        self, node,
                        "raw packed-layout offset arithmetic in a "
                        "subscript; use PackedLayout fields (the "
                        "`layout-definition` scope in parallel/packed.py) "
                        "so the device program, the window engine and "
                        "the NumPy mirror cannot drift")
                    break
