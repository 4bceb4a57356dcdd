"""KTL112 — untrusted-input taint tracking (whole-program).

Values originating from the wire (``# keplint: taint-source`` functions
such as ``peek_node_name``) or from HTTP request surfaces (``.headers``
/ ``.path`` / ``.body`` / query reads inside ``http-handler``-role
functions) are **tainted** until they pass a sanitizer — a function
marked ``# keplint: sanitizes`` (validate/clamp/coerce helpers, or
``decode_report`` itself, which rejects malformed input) or a built-in
coercion (``int``/``float``/…). Taint propagates through assignments,
string operations, and **resolved call edges** (a tainted argument
taints the callee's parameter; a function returning tainted data taints
its call sites), so a wire name laundered through two helper frames is
still caught at the sink.

Sinks — where hostile bytes become unbounded metric cardinality, store
churn, or log forgery:

- Prometheus label values (``.labels(...)`` args, ``add_metric([...])``
  label lists);
- keys inserted into object-attached stores (``self._nodes[name] = …``:
  the scoreboard/tracker/dedup bounded-LRU class);
- sequence indexing with a tainted index;
- arguments of logging calls (newline injection forges log lines);
- any argument to a function marked ``# keplint: taint-sink``.

A membership guard (``if x in allowed:``) clears taint in its body, and
functions marked ``sanitizes``/``taint-source`` are themselves exempt
from sink checks — they ARE the validation boundary.
"""

from __future__ import annotations

import ast
from typing import Iterable

from kepler_tpu_torch.analysis.engine import Diagnostic, ProjectRule, register
from kepler_tpu_torch.analysis.rules.common import (
    call_canonical,
    child_bodies,
    imports_for,
    qualname,
    stmt_exprs,
    terminal,
)

# request-object surfaces that carry raw network bytes
_REQUEST_ATTRS = frozenset({
    "headers", "path", "body", "rfile", "requestline", "query",
})
_HANDLER_ROLE = "http-handler"

# built-in coercions whose result cannot carry hostile bytes
_COERCERS = frozenset({
    "int", "float", "bool", "len", "abs", "round", "min", "max",
    "hash", "ord", "html.escape",
})

_LOG_METHODS = frozenset({"debug", "info", "warning", "error",
                          "exception", "critical"})
_LOG_RECEIVERS = frozenset({"log", "logger", "logging"})

_MAX_ITERS = 12


class _FnTaint:
    """Mutable interprocedural summary for one function."""

    __slots__ = ("params", "returns")

    def __init__(self) -> None:
        self.params: dict[str, str] = {}   # param name → origin
        self.returns: str | None = None    # origin when return is tainted


@register
class TaintRule(ProjectRule):
    id = "KTL112"
    name = "untrusted-taint"
    summary = ("wire/HTTP-derived values must pass a registered "
               "sanitizer before reaching label values, store keys, "
               "sequence indexes, or log calls")
    rationale = (
        "Node names and header fields come off an untrusted network; PR "
        "8 found by hand that junk wire names were evicting real "
        "scoreboard rows, and every Prometheus label minted from such a "
        "value is unbounded series cardinality. The fix discipline is a "
        "visible chokepoint: sources (`taint-source`, HTTP request "
        "surfaces) mark data hostile, sanitizers (`sanitizes` — "
        "validate/clamp/coerce) launder it, and the call-graph "
        "propagation means a helper hop (ingest → degradation "
        "accounting → scoreboard insert) cannot silently drop the "
        "obligation the way a per-file check would.")

    def check_project(self, project) -> Iterable[Diagnostic]:
        summaries: dict[str, _FnTaint] = {
            fid: _FnTaint() for fid in project.functions}
        # fixpoint: propagate param/return taint over the call graph
        for _ in range(_MAX_ITERS):
            changed = False
            for fid, info in project.functions.items():
                if not self._seeded(project, info, summaries):
                    continue
                changed |= self._analyze(project, info, summaries,
                                         sinks=None)
            if not changed:
                break
        diags: list[Diagnostic] = []
        for fid, info in project.functions.items():
            if not self._seeded(project, info, summaries):
                continue
            if info.marker("sanitizes") is not None \
                    or info.marker("taint-source") is not None:
                continue  # the validation boundary works on raw bytes
            self._analyze(project, info, summaries, sinks=diags)
        # loop bodies are walked twice for loop-carried taint, which can
        # duplicate a sink finding — diagnostics are frozen/hashable
        return sorted(set(diags))

    @staticmethod
    def _seeded(project, info, summaries: dict) -> bool:
        """Only functions that can possibly see taint are analyzed: they
        have tainted params, run under the http-handler role, ARE a
        source, or call a source / a function whose return is (so far
        known to be) tainted — everything else is skipped, which is what
        keeps the whole-program pass inside the wall-clock budget.
        Re-evaluated every fixpoint iteration, so return-taint
        discovered mid-pass seeds its callers on the next one."""
        if summaries[info.func_id].params \
                or _HANDLER_ROLE in info.roles \
                or info.marker("taint-source") is not None:
            return True
        for site in project.calls.get(info.func_id, []):
            callee = project.functions[site.callee]
            if callee.marker("taint-source") is not None \
                    or summaries[callee.func_id].returns:
                return True
        return False

    # -- one function ------------------------------------------------------

    def _analyze(self, project, info, summaries,
                 sinks: list | None) -> bool:
        """Walk ``info`` propagating taint; update interprocedural
        summaries (returns True when they grew). With ``sinks`` set,
        emit sink diagnostics instead."""
        my = summaries[info.func_id]
        env: dict[str, str] = dict(my.params)
        imports = imports_for(info.ctx)
        http_role = _HANDLER_ROLE in info.roles
        changed = False

        def taint_of(node: ast.AST) -> str | None:
            if isinstance(node, ast.Name):
                return env.get(node.id)
            if isinstance(node, ast.Attribute):
                # `.path`/`.headers`/… on anything a handler holds is
                # request surface — EXCEPT attributes of imported
                # modules (`os.path`, `urllib.parse`), which are code,
                # not data off the wire
                if http_role and node.attr in _REQUEST_ATTRS \
                        and not (isinstance(node.value, ast.Name)
                                 and node.value.id in imports.alias):
                    return f"HTTP request surface .{node.attr}"
                return taint_of(node.value)
            if isinstance(node, ast.Subscript):
                return taint_of(node.value) or (
                    taint_of(node.slice)
                    if not isinstance(node.slice, ast.Slice) else None)
            if isinstance(node, ast.Call):
                return call_taint(node)
            if isinstance(node, (ast.BinOp,)):
                return taint_of(node.left) or taint_of(node.right)
            if isinstance(node, ast.BoolOp):
                for v in node.values:
                    t = taint_of(v)
                    if t:
                        return t
            if isinstance(node, ast.JoinedStr):
                for v in node.values:
                    if isinstance(v, ast.FormattedValue):
                        t = taint_of(v.value)
                        if t:
                            return t
                return None
            if isinstance(node, ast.FormattedValue):
                return taint_of(node.value)
            if isinstance(node, ast.IfExp):
                return taint_of(node.body) or taint_of(node.orelse)
            if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
                for elt in node.elts:
                    t = taint_of(elt)
                    if t:
                        return t
                return None
            if isinstance(node, ast.Starred):
                return taint_of(node.value)
            if isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                 ast.GeneratorExp)):
                for gen in node.generators:
                    t = taint_of(gen.iter)
                    if t:
                        return t
                return None
            if isinstance(node, ast.Await):
                return taint_of(node.value)
            # Compare / Constant / Lambda / comprehension vars: clean
            return None

        def call_taint(call: ast.Call) -> str | None:
            nonlocal changed
            canon = call_canonical(call, imports) or ""
            callee_id, _recv = project.resolve_call(
                info, call, local_types)
            callee = project.functions.get(callee_id) \
                if callee_id else None
            arg_taints = [taint_of(a) for a in call.args]
            kw_taints = {kw.arg: taint_of(kw.value)
                         for kw in call.keywords if kw.arg}
            if callee is not None:
                # propagate into the callee's parameters
                csum = summaries[callee.func_id]
                params = self._param_names(callee)
                for i, t in enumerate(arg_taints):
                    if t and i < len(params) \
                            and params[i] not in csum.params:
                        csum.params[params[i]] = (
                            f"{t}, via {info.qual}()")
                        changed = True
                for name, t in kw_taints.items():
                    if t and name in params and name not in csum.params:
                        csum.params[name] = f"{t}, via {info.qual}()"
                        changed = True
                if callee.marker("sanitizes") is not None:
                    return None
                if callee.marker("taint-source") is not None:
                    return f"{callee.name}() [taint-source]"
                if csum.returns:
                    return f"{callee.name}() → {csum.returns}"
            if canon in _COERCERS or terminal(canon) in ("isoformat",):
                return None
            # method on a tainted receiver (str ops etc.) or any
            # tainted argument: conservatively tainted result
            recv_taint = None
            if isinstance(call.func, ast.Attribute):
                recv_taint = taint_of(call.func.value)
            for t in [recv_taint] + arg_taints + list(kw_taints.values()):
                if t:
                    return t
            return None

        def check_sinks(stmt: ast.AST) -> None:
            if sinks is None:
                return
            for node in self._stmt_exprs(stmt):
                if isinstance(node, ast.Subscript) \
                        and isinstance(node.ctx, ast.Load) \
                        and not isinstance(node.slice, ast.Slice) \
                        and not isinstance(node.slice, ast.Constant):
                    t = taint_of(node.slice)
                    if t:
                        sinks.append(info.ctx.diag(
                            self, node,
                            f"tainted value ({t}) used as a sequence/"
                            f"mapping index in {info.qual}(); validate "
                            "or clamp it through a registered sanitizer "
                            "first"))
                if not isinstance(node, ast.Call):
                    continue
                func = node.func
                attr = func.attr if isinstance(func, ast.Attribute) \
                    else None
                if attr == "labels":
                    for arg in list(node.args) + [kw.value for kw in
                                                  node.keywords]:
                        t = taint_of(arg)
                        if t:
                            sinks.append(info.ctx.diag(
                                self, node,
                                f"tainted value ({t}) used as a "
                                f"Prometheus label in {info.qual}(); "
                                "unbounded hostile cardinality — "
                                "sanitize first"))
                elif attr == "add_metric" and node.args:
                    first = node.args[0]
                    elts = first.elts if isinstance(
                        first, (ast.List, ast.Tuple)) else [first]
                    for elt in elts:
                        t = taint_of(elt)
                        if t:
                            sinks.append(info.ctx.diag(
                                self, node,
                                f"tainted value ({t}) used as a "
                                f"Prometheus label in {info.qual}(); "
                                "unbounded hostile cardinality — "
                                "sanitize first"))
                elif attr in _LOG_METHODS and isinstance(
                        func, ast.Attribute):
                    recv = terminal(qualname(func.value) or "")
                    if recv in _LOG_RECEIVERS:
                        for arg in node.args:
                            t = taint_of(arg)
                            if t:
                                sinks.append(info.ctx.diag(
                                    self, node,
                                    f"tainted value ({t}) in a log "
                                    f"call in {info.qual}(); newline "
                                    "injection forges log lines — "
                                    "sanitize first"))
                                break
                callee_id, _ = project.resolve_call(
                    info, node, local_types)
                callee = project.functions.get(callee_id) \
                    if callee_id else None
                if callee is not None and \
                        callee.marker("taint-sink") is not None:
                    what = callee.marker("taint-sink") or "sink"
                    for arg in list(node.args) + [kw.value for kw in
                                                  node.keywords]:
                        t = taint_of(arg)
                        if t:
                            sinks.append(info.ctx.diag(
                                self, node,
                                f"tainted value ({t}) passed to "
                                f"{callee.name}() (taint-sink"
                                f"{'=' + what if what else ''}) in "
                                f"{info.qual}(); sanitize first"))
                            break

        def assign_target(target: ast.AST, t: str | None,
                          stmt: ast.AST) -> None:
            if isinstance(target, ast.Name):
                if t:
                    env[target.id] = t
                else:
                    env.pop(target.id, None)
            elif isinstance(target, (ast.Tuple, ast.List)):
                for elt in target.elts:
                    assign_target(elt, t, stmt)
            elif isinstance(target, ast.Starred):
                assign_target(target.value, t, stmt)
            elif isinstance(target, ast.Subscript) and sinks is not None:
                # store-key sink: obj.attr[tainted_key] = …
                inner = target.value
                if isinstance(inner, ast.Attribute) \
                        and not isinstance(target.slice, ast.Slice):
                    kt = taint_of(target.slice)
                    if kt:
                        sinks.append(info.ctx.diag(
                            self, stmt,
                            f"tainted value ({kt}) inserted as a key "
                            f"into {qualname(inner) or 'a store'} in "
                            f"{info.qual}(); hostile names churn/evict "
                            "bounded stores — sanitize first"))

        def walk(stmts: list) -> None:
            nonlocal changed
            for stmt in stmts:
                if isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                    continue
                check_sinks(stmt)
                # taint_of on call expressions also drives propagation
                for expr in self._stmt_exprs(stmt):
                    if isinstance(expr, ast.Call):
                        taint_of(expr)
                if isinstance(stmt, ast.Assign):
                    t = taint_of(stmt.value)
                    for target in stmt.targets:
                        assign_target(target, t, stmt)
                elif isinstance(stmt, ast.AnnAssign) and stmt.value:
                    assign_target(stmt.target, taint_of(stmt.value),
                                  stmt)
                elif isinstance(stmt, ast.AugAssign):
                    t = taint_of(stmt.value) or taint_of(stmt.target)
                    assign_target(stmt.target, t, stmt)
                elif isinstance(stmt, ast.Return) and stmt.value:
                    t = taint_of(stmt.value)
                    if t and my.returns is None:
                        my.returns = t
                        changed = True
                elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                    assign_target(stmt.target, taint_of(stmt.iter),
                                  stmt)
                elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                    for item in stmt.items:
                        if item.optional_vars is not None:
                            assign_target(item.optional_vars,
                                          taint_of(item.context_expr),
                                          stmt)
                if isinstance(stmt, ast.If):
                    cleared = self._membership_guard(stmt.test)
                    saved = {n: env[n] for n in cleared if n in env}
                    for n in cleared:
                        env.pop(n, None)
                    walk(stmt.body)
                    env.update(saved)
                    walk(stmt.orelse)
                    continue
                for body in self._child_bodies(stmt):
                    walk(body)
                    if isinstance(stmt, (ast.For, ast.AsyncFor,
                                         ast.While)):
                        walk(body)  # second pass: loop-carried taint

        local_types = project.local_types(info)
        walk(list(info.node.body))
        return changed

    @staticmethod
    def _membership_guard(test: ast.AST) -> set[str]:
        """``if x in allowed:`` validates ``x`` for the guarded body."""
        out: set[str] = set()
        if isinstance(test, ast.Compare) and len(test.ops) == 1 \
                and isinstance(test.ops[0], ast.In) \
                and isinstance(test.left, ast.Name):
            out.add(test.left.id)
        if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
            for v in test.values:
                out |= TaintRule._membership_guard(v)
        return out

    @staticmethod
    def _param_names(info) -> list[str]:
        args = info.node.args
        names = [a.arg for a in list(args.posonlyargs) + list(args.args)]
        if names and names[0] in ("self", "cls"):
            names = names[1:]
        return names

    _stmt_exprs = staticmethod(stmt_exprs)
    _child_bodies = staticmethod(child_bodies)
