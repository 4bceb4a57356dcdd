"""Shared AST helpers for the keplint rule modules.

Everything here is pure lookup over one :class:`FileContext`; the
whole-program analogs (cross-module resolution, call graph) live in
``kepler_tpu_torch.analysis.project``.
"""

from __future__ import annotations

import ast

from kepler_tpu_torch.analysis.engine import FileContext

__all__ = [
    "BLOCKING_BARE",
    "BLOCKING_CALLS",
    "BLOCKING_ROOTS",
    "WALL_CLOCK_CALLS",
    "call_canonical",
    "child_bodies",
    "imports_for",
    "is_blocking_call",
    "jitted_functions",
    "qualname",
    "stmt_exprs",
    "terminal",
    "Imports",
]


def qualname(node: ast.AST) -> str | None:
    """Dotted name for a Name/Attribute chain; None for anything else."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class Imports:
    """Per-file import alias map, so ``_time.time()`` and
    ``from time import time as now; now()`` both canonicalize to
    ``time.time``."""

    def __init__(self, tree: ast.Module) -> None:
        self.alias: dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        self.alias[a.asname] = a.name
                    else:
                        head = a.name.split(".")[0]
                        self.alias[head] = head
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self.alias[a.asname or a.name] = \
                        f"{node.module}.{a.name}"

    def canonical(self, qual: str | None) -> str | None:
        if not qual:
            return None
        head, _, rest = qual.partition(".")
        head = self.alias.get(head, head)
        return f"{head}.{rest}" if rest else head


def imports_for(ctx: FileContext) -> Imports:
    """One alias map per file, shared by every rule that needs it."""
    cached = getattr(ctx, "_keplint_imports", None)
    if cached is None:
        cached = Imports(ctx.tree)
        ctx._keplint_imports = cached  # type: ignore[attr-defined]
    return cached


def call_canonical(node: ast.Call, imports: Imports) -> str | None:
    return imports.canonical(qualname(node.func))


def terminal(name: str | None) -> str:
    return name.rsplit(".", 1)[-1] if name else ""


def stmt_exprs(stmt: ast.AST):
    """A statement's OWN expression nodes (an If's test, a For's iter, an
    Assign's value/targets) — nested statements and function/lambda
    bodies are excluded; statement walks visit those separately."""
    stack = list(ast.iter_child_nodes(stmt))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.stmt, ast.FunctionDef,
                             ast.AsyncFunctionDef, ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def child_bodies(node: ast.AST) -> list[list]:
    """Every nested statement list of a compound statement."""
    out = []
    for attr in ("body", "orelse", "finalbody"):
        val = getattr(node, attr, None)
        if val:
            out.append(val)
    for handler in getattr(node, "handlers", []) or []:
        out.append(handler.body)
    for case in getattr(node, "cases", []) or []:
        out.append(case.body)
    return out


WALL_CLOCK_CALLS = {
    "time.time",
    "datetime.datetime.now",
    "datetime.datetime.utcnow",
    "datetime.datetime.today",
    "datetime.date.today",
}

# blocking-call vocabulary shared by the lexical KTL106 and the
# call-graph-aware KTL113
BLOCKING_ROOTS = {"subprocess", "socket", "urllib", "requests", "http"}
BLOCKING_CALLS = {"time.sleep"}
BLOCKING_BARE = {"open", "input", "print"}


def is_blocking_call(call: ast.Call, imports: Imports) -> str | None:
    """Canonical name when ``call`` is a blocking/IO call, else None.
    Includes the ``…lower(…).compile(…)`` XLA-compile shape (a
    multi-second stall), matched structurally so ``re.compile`` stays
    out."""
    canon = call_canonical(call, imports) or ""
    root = canon.split(".")[0]
    term = terminal(canon)
    if (canon in BLOCKING_CALLS or term == "sleep"
            or root in BLOCKING_ROOTS or canon in BLOCKING_BARE):
        return canon or term
    func = call.func
    if (isinstance(func, ast.Attribute) and func.attr == "compile"
            and isinstance(func.value, ast.Call)
            and isinstance(func.value.func, ast.Attribute)
            and func.value.func.attr == "lower"):
        return "lower().compile"
    return None


def _is_jit(canon: str) -> bool:
    return canon in ("jax.jit", "jit") or canon.endswith(".jit")


def _launches_kernel(fn: ast.FunctionDef) -> bool:
    """True when ``fn`` calls a symbol of a built kernel library
    (``lib.kt_outer_product_attribution(...)``): a kernel wrapper."""
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr.startswith("kt_")):
            return True
    return False


def _autograd_functions(ctx: FileContext, imports: Imports) -> set[int]:
    """ids of the ``forward``/``backward`` methods of every class that
    derives from ``torch.autograd.Function``."""
    out: set[int] = set()
    for node in ctx.walk_nodes:
        if not isinstance(node, ast.ClassDef):
            continue
        if not any((imports.canonical(qualname(b)) or "").endswith(
                "autograd.Function") for b in node.bases):
            continue
        for item in node.body:
            if (isinstance(item, ast.FunctionDef)
                    and item.name in ("forward", "backward")):
                out.add(id(item))
    return out


def jitted_functions(ctx: FileContext) -> list[ast.FunctionDef]:
    """The functions whose bodies a device runs or mirrors: the hand
    kernels' wrappers (a function that calls a ``kt_*`` symbol of a built
    kernel library), their plain versions (``*_ref``), the ``forward``
    and ``backward`` of every ``torch.autograd.Function``, and — as in
    the reference package — functions decorated with a ``jit`` (directly
    or via functools.partial) and kernels passed to ``pallas_call``.
    Computed once per file per run (shared by KTL107 and KTL109) over
    the cached node list."""
    cached = getattr(ctx, "_keplint_jitted", None)
    if cached is not None:
        return cached
    imports = imports_for(ctx)
    out: list[ast.FunctionDef] = []
    kernel_names: set[str] = set()
    fns: list[ast.FunctionDef] = []
    for node in ctx.walk_nodes:
        if isinstance(node, ast.FunctionDef):
            fns.append(node)
        elif isinstance(node, ast.Call):
            canon = call_canonical(node, imports) or ""
            if terminal(canon) == "pallas_call" and node.args:
                name = qualname(node.args[0])
                if name and "." not in name:
                    kernel_names.add(name)
    autograd = _autograd_functions(ctx, imports)
    for node in fns:
        if (node.name in kernel_names or node.name.endswith("_ref")
                or id(node) in autograd or _launches_kernel(node)):
            out.append(node)
            continue
        for deco in node.decorator_list:
            target = deco.func if isinstance(deco, ast.Call) else deco
            canon = imports.canonical(qualname(target)) or ""
            if _is_jit(canon):
                out.append(node)
                break
            if (isinstance(deco, ast.Call)
                    and terminal(canon) == "partial" and deco.args):
                inner = imports.canonical(qualname(deco.args[0])) or ""
                if _is_jit(inner):
                    out.append(node)
                    break
    ctx._keplint_jitted = out  # type: ignore[attr-defined]
    return out
