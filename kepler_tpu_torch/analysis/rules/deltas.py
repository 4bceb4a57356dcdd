"""KTL102 — wrap-aware energy-counter deltas."""

from __future__ import annotations

import ast
import re
from typing import Iterable

from kepler_tpu_torch.analysis.engine import Diagnostic, FileContext, Rule, register
from kepler_tpu_torch.analysis.rules.common import qualname, terminal

_COUNTERISH = re.compile(r"(^|_)(energy|counter)(_|$)|(^|_)uj$",
                         re.IGNORECASE)
# time.perf_counter / counters of unrelated kinds are not energy counters
_NOT_COUNTERISH = re.compile(r"perf_counter$", re.IGNORECASE)


def _is_counterish(name: str) -> bool:
    return bool(_COUNTERISH.search(name)
                and not _NOT_COUNTERISH.search(name))

# the canonical helper (and the docstring'd inline implementation it
# wraps) are the two places allowed to do raw counter arithmetic
_DELTA_HELPER_SUFFIXES = ("kepler_tpu_torch/ops/deltas.py",)


def _operand_name(node: ast.AST) -> str:
    """Identifier a subtraction operand 'reads from': the terminal
    attribute/name, looking through a call (``zone.energy() - prev``)."""
    if isinstance(node, ast.Call):
        return terminal(qualname(node.func))
    return terminal(qualname(node))


@register
class WrapAwareDeltaRule(Rule):
    id = "KTL102"
    name = "wrap-aware-delta"
    summary = ("energy-counter subtraction must go through "
               "ops.deltas.energy_delta")
    rationale = (
        "RAPL counters wrap at max_energy_range_uj; a raw `current - "
        "prev` turns every wrap into a huge negative delta that corrupts "
        "cumulative joules and the attribution numerator. All counter "
        "delta math goes through `kepler_tpu_torch.ops.deltas.energy_delta` / "
        "`energy_deltas` (exact wraparound semantics, reference "
        "node.go:87-98).")

    def check(self, ctx: FileContext) -> Iterable[Diagnostic]:
        if ctx.rel_path.endswith(_DELTA_HELPER_SUFFIXES):
            return
        for node in ctx.walk_nodes:
            if not (isinstance(node, ast.BinOp)
                    and isinstance(node.op, ast.Sub)):
                continue
            left = _operand_name(node.left)
            right = _operand_name(node.right)
            if not (left and right):
                continue  # literals / nested expressions: not counter math
            if _is_counterish(left) or _is_counterish(right):
                yield ctx.diag(
                    self, node,
                    f"raw subtraction on energy-counter-like operands "
                    f"({left!r} - {right!r}); use "
                    "kepler_tpu_torch.ops.deltas.energy_delta for wrap-aware "
                    "math")
