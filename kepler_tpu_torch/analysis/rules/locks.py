"""KTL108 (lexical) + KTL111 (whole-program) — lock discipline.

KTL108 is the fast intra-file tier: guarded attribute writes and
requires-lock calls checked within one class, one file. KTL111 runs on
the :class:`~kepler_tpu_torch.analysis.project.ProjectContext` and sees what
the lexical tier structurally cannot:

- the **lock-acquisition order graph** across call edges — cycles are
  potential deadlocks (RacerD-style, PAPERS.md precedent), and
  acquiring a known non-reentrant lock that is already held (directly
  or through a helper call chain) is a guaranteed one;
- ``requires-lock`` calls and ``guarded-by`` writes **through receiver
  objects of other classes/modules** (``self._spool._append_locked()``
  from the agent; a subclass writing a base-guarded attribute), which
  KTL108's ``self.``-only view cannot resolve.
"""

from __future__ import annotations

import ast
from typing import Iterable, Iterator

from kepler_tpu_torch.analysis.engine import (
    Diagnostic,
    FileContext,
    ProjectRule,
    Rule,
    register,
)
from kepler_tpu_torch.analysis.rules.common import qualname

# ---------------------------------------------------------------------------
# KTL108 — lock-guarded attributes (lexical tier)
# ---------------------------------------------------------------------------


def _with_locks(node: ast.With) -> set[str]:
    out: set[str] = set()
    for item in node.items:
        qual = qualname(item.context_expr)
        if qual and qual.startswith("self."):
            out.add(qual[len("self."):])
    return out


@register
class LockGuardedRule(Rule):
    id = "KTL108"
    name = "lock-guarded"
    summary = ("attributes annotated `# keplint: guarded-by=<lock>` are "
               "only written under `with self.<lock>`")
    rationale = (
        "The monitor/aggregator publish data to scrape threads through "
        "attributes whose write side is documented as lock-guarded "
        "(reads are lock-free reference swaps). The contract is machine-"
        "readable: annotate the attribute in __init__ with `# keplint: "
        "guarded-by=_lock`; functions that may only be called with the "
        "lock held carry `# keplint: requires-lock=_lock`, and every "
        "call to them must itself hold the lock (a small lexical effect "
        "system — KTL111 extends it across call edges and modules).")

    _EXEMPT_METHODS = frozenset({"__init__", "init"})

    def check(self, ctx: FileContext) -> Iterable[Diagnostic]:
        for cls in ctx.walk_nodes:
            if isinstance(cls, ast.ClassDef):
                yield from self._check_class(ctx, cls)

    def _check_class(self, ctx: FileContext,
                     cls: ast.ClassDef) -> Iterator[Diagnostic]:
        guarded: dict[str, str] = {}
        requires: dict[str, str] = {}
        methods = [n for n in cls.body
                   if isinstance(n, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))]
        for fn in methods:
            lock = ctx.marker_on(fn, "requires-lock")
            if lock:
                requires[fn.name] = lock
            if fn.name not in self._EXEMPT_METHODS:
                continue
            for stmt in ast.walk(fn):
                if not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                    continue
                for kind, arg in ctx.directives.get(stmt.lineno, []):
                    if kind != "guarded-by" or not arg:
                        continue
                    targets = (stmt.targets
                               if isinstance(stmt, ast.Assign)
                               else [stmt.target])
                    for t in targets:
                        if (isinstance(t, ast.Attribute)
                                and isinstance(t.value, ast.Name)
                                and t.value.id == "self"):
                            guarded[t.attr] = arg
        if not guarded and not requires:
            return
        for fn in methods:
            if fn.name in self._EXEMPT_METHODS:
                continue
            held: set[str] = set()
            if fn.name in requires:
                held = {requires[fn.name]}
            yield from self._walk(ctx, fn, list(fn.body), held,
                                  guarded, requires)

    def _walk(self, ctx: FileContext, fn: ast.AST, body: list,
              held: set[str], guarded: dict[str, str],
              requires: dict[str, str]) -> Iterator[Diagnostic]:
        for node in body:
            extra: set[str] = set()
            if isinstance(node, ast.With):
                extra = _with_locks(node)
            yield from self._check_stmt(ctx, fn, node, held | extra,
                                        guarded, requires)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # a closure runs later, possibly without the lock held
                yield from self._walk(ctx, fn, node.body, set(),
                                      guarded, requires)
                continue
            for child_body in self._child_bodies(node):
                yield from self._walk(ctx, fn, child_body, held | extra,
                                      guarded, requires)

    @staticmethod
    def _child_bodies(node: ast.AST) -> list[list]:
        out = []
        for attr in ("body", "orelse", "finalbody"):
            val = getattr(node, attr, None)
            if val:
                out.append(val)
        for handler in getattr(node, "handlers", []) or []:
            out.append(handler.body)
        return out

    def _check_stmt(self, ctx: FileContext, fn: ast.AST, node: ast.AST,
                    held: set[str], guarded: dict[str, str],
                    requires: dict[str, str]) -> Iterator[Diagnostic]:
        targets: list[ast.expr] = []
        if isinstance(node, ast.Assign):
            targets = list(node.targets)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        for target in targets:
            inner = target
            while isinstance(inner, ast.Subscript):
                inner = inner.value
            if (isinstance(inner, ast.Attribute)
                    and isinstance(inner.value, ast.Name)
                    and inner.value.id == "self"
                    and inner.attr in guarded
                    and guarded[inner.attr] not in held):
                yield ctx.diag(
                    self, node,
                    f"write to self.{inner.attr} (guarded by "
                    f"self.{guarded[inner.attr]}) outside `with "
                    f"self.{guarded[inner.attr]}` in "
                    f"{getattr(fn, 'name', '?')}()")
        # calls into requires-lock functions need the lock too; examine
        # only the expressions attached to THIS statement (nested
        # statements are visited by _walk, so they are never double-
        # counted)
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, ast.expr):
                continue
            for expr in ast.walk(child):
                if not isinstance(expr, ast.Call):
                    continue
                qual = qualname(expr.func) or ""
                if not qual.startswith("self."):
                    continue
                callee = qual[len("self."):]
                if "." in callee or callee not in requires:
                    continue
                if requires[callee] not in held:
                    yield ctx.diag(
                        self, expr,
                        f"call to self.{callee}() requires holding "
                        f"self.{requires[callee]} (marked requires-lock)"
                        " — wrap the call in `with self."
                        f"{requires[callee]}:`")


# ---------------------------------------------------------------------------
# KTL111 — lock order + interprocedural lock contracts (whole-program)
# ---------------------------------------------------------------------------

# lock kinds that are NOT re-entrant: acquiring one that is already held
# on the same thread deadlocks immediately
_NON_REENTRANT = frozenset({"Lock", "Semaphore"})


@register
class LockOrderRule(ProjectRule):
    id = "KTL111"
    name = "lock-order"
    summary = ("no cycles in the cross-module lock-acquisition graph, no "
               "re-acquisition of held non-reentrant locks, and "
               "`requires-lock`/`guarded-by` contracts hold through "
               "helper calls and across modules")
    rationale = (
        "The device plane is genuinely concurrent (ingest HTTP threads, "
        "the pipelined window thread, the monitor refresh loop, the "
        "_FetchWorker), and KTL108's lexical view stops at the first "
        "helper-function hop. KTL111 derives the lock-acquisition graph "
        "from `with`-lock regions across resolved call edges: a cycle "
        "between two locks is a potential deadlock the moment two "
        "threads interleave; acquiring a known `threading.Lock` that is "
        "already held (even two frames up, through helpers) is a "
        "guaranteed one; and a call to a `requires-lock` method of "
        "ANOTHER object/class (`self._spool._append_locked()`) or a "
        "write to another class's `guarded-by` attribute must hold that "
        "receiver's lock — contracts the per-file tier cannot resolve.")

    def check_project(self, project) -> Iterable[Diagnostic]:
        yield from self._check_reacquire(project)
        yield from self._check_cycles(project)
        yield from self._check_cross_requires(project)
        yield from self._check_cross_guarded(project)

    # -- self-deadlock ----------------------------------------------------

    def _check_reacquire(self, project) -> Iterator[Diagnostic]:
        # lexical: `with self._lock` while self._lock already held
        for info in project.functions.values():
            for lid, qual, node, held in info.acquires:
                if lid in held:
                    kind = project.lock_kind(lid) or "unknown kind"
                    if kind in ("RLock", "Condition"):
                        continue  # re-entrant by construction
                    yield info.ctx.diag(
                        self, node,
                        f"acquisition of {qual} while already held in "
                        f"{info.qual}() ({kind}); a non-reentrant lock "
                        "self-deadlocks — split the locked section or "
                        "mark the callee requires-lock")
        # call-mediated: calling a function whose closure re-acquires a
        # lock held at the site (known non-reentrant kinds only: an
        # unknown lock reached conditionally is too speculative to fail)
        for sites in project.calls.values():
            for site in sites:
                callee = project.functions[site.callee]
                req = callee.marker("requires-lock")
                for lid in site.held_ids:
                    if project.lock_kind(lid) not in _NON_REENTRANT:
                        continue
                    if lid not in callee.closure_acquires:
                        continue
                    # a requires-lock callee legitimately expects the
                    # lock; its own `with` would be flagged above
                    if req and lid.endswith(f".{req}"):
                        continue
                    yield site.ctx.diag(
                        self, site.node,
                        f"call to {callee.qual}() while holding "
                        f"{self._short(lid)}; the callee (or something "
                        "it calls) re-acquires that non-reentrant lock "
                        "— deadlock")

    # -- cycles ------------------------------------------------------------

    def _check_cycles(self, project) -> Iterator[Diagnostic]:
        edges: dict[str, dict[str, tuple]] = {}  # a → b → (ctx, node, via)

        def add(a: str, b: str, ctx, node, via: str) -> None:
            if a == b:
                return  # self-deadlock handled above
            edges.setdefault(a, {}).setdefault(b, (ctx, node, via))

        for info in project.functions.values():
            for lid, qual, node, held in info.acquires:
                for h in held:
                    add(h, lid, info.ctx, node, info.qual)
        for sites in project.calls.values():
            for site in sites:
                callee = project.functions[site.callee]
                for lid in callee.closure_acquires:
                    for h in site.held_ids:
                        add(h, lid, site.ctx, site.node,
                            f"{project.functions[site.caller].qual} → "
                            f"{callee.qual}")
        # DFS cycle detection, reporting each cycle once at its smallest
        # participating edge
        seen_cycles: set[frozenset] = set()
        color: dict[str, int] = {}
        stack: list[str] = []

        def dfs(n: str) -> Iterator[tuple]:
            color[n] = 1
            stack.append(n)
            for m in sorted(edges.get(n, {})):
                if color.get(m, 0) == 1:
                    cycle = stack[stack.index(m):] + [m]
                    key = frozenset(cycle)
                    if key not in seen_cycles:
                        seen_cycles.add(key)
                        yield tuple(cycle)
                elif color.get(m, 0) == 0:
                    yield from dfs(m)
            stack.pop()
            color[n] = 2

        for n in sorted(edges):
            if color.get(n, 0) == 0:
                for cycle in dfs(n):
                    a, b = cycle[0], cycle[1]
                    ctx, node, via = edges[a][b]
                    order = " → ".join(self._short(x) for x in cycle)
                    yield ctx.diag(
                        self, node,
                        f"lock-order cycle {order} (this edge acquired "
                        f"via {via}); two threads taking the locks in "
                        "opposite order deadlock — impose one global "
                        "acquisition order")

    # -- cross-class requires-lock ----------------------------------------

    def _check_cross_requires(self, project) -> Iterator[Diagnostic]:
        for sites in project.calls.values():
            for site in sites:
                callee = project.functions[site.callee]
                req = callee.marker("requires-lock")
                if not req or not site.receiver:
                    continue
                caller = project.functions[site.caller]
                if (site.receiver == "self"
                        and callee.class_key == caller.class_key):
                    continue  # same class, same file: KTL108's tier
                if caller.name in ("__init__", "init"):
                    continue
                needed = f"{site.receiver}.{req}"
                if needed in site.held_raw:
                    continue
                yield site.ctx.diag(
                    self, site.node,
                    f"call to {callee.qual}() requires holding "
                    f"{needed} (marked requires-lock={req}) — the "
                    "lexical tier cannot see this contract from "
                    f"{caller.qual}(); wrap the call in `with {needed}:`")

    # -- cross-class guarded-by writes ------------------------------------

    def _check_cross_guarded(self, project) -> Iterator[Diagnostic]:
        for info in project.functions.values():
            if info.name in ("__init__", "init"):
                continue
            ltypes = None
            for qual, node, held_raw in info.writes:
                parts = qual.split(".")
                recv, attr = ".".join(parts[:-1]), parts[-1]
                owner_key = None
                if recv == "self" and info.class_key:
                    # inherited guarded attrs only: own-class ones are
                    # KTL108's (and would double-report)
                    own = project.classes.get(info.class_key)
                    if own is not None and attr in own.guarded:
                        continue
                    owner_key = info.class_key
                elif parts[0] == "self" and len(parts) == 3:
                    owner_key = project._attr_type_on(
                        info.class_key, parts[1])
                elif len(parts) == 2:
                    if ltypes is None:
                        ltypes = project.local_types(info)
                    owner_key = ltypes.get(parts[0])
                if owner_key is None:
                    continue
                lock = project.guarded_on(owner_key, attr)
                if not lock:
                    continue
                needed = f"{recv}.{lock}"
                if needed in held_raw:
                    continue
                yield info.ctx.diag(
                    self, node,
                    f"write to {qual} (guarded by {lock} on "
                    f"{self._short(owner_key)}) outside `with {needed}` "
                    f"in {info.qual}() — cross-class guarded-by "
                    "violation the lexical tier cannot see")

    @staticmethod
    def _short(lock_or_class_id: str) -> str:
        """Strip the module prefix for readable messages:
        ``kepler_tpu_torch.fleet.aggregator:Aggregator._lock`` →
        ``Aggregator._lock``."""
        _, _, tail = lock_or_class_id.rpartition(":")
        return tail or lock_or_class_id
