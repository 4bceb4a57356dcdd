"""Whole-program analysis context for keplint.

Per-file AST rules (KTL101-110) stop seeing an invariant the moment it
crosses a call edge: a helper hop hides a lock contract, a wire-decoded
name loses its taint, a ``time.sleep`` two frames below the refresh
loop is invisible to the lexical hot-loop check.  :class:`ProjectContext`
closes that gap without leaving stdlib ``ast``:

- every file is parsed **once** per run (the contexts are shared with
  the per-file rules — see ``engine.lint_paths``);
- a module-level symbol table maps imports/classes/functions to global
  ids (``module:Class.method``);
- light type inference (constructor assignments, parameter annotations,
  ``self.attr = ClassName(...)`` in ``__init__``) resolves receiver
  classes so ``self._scoreboard.observe_report(...)`` becomes a real
  call edge into another module;
- a call graph links every resolved call site, carrying the set of
  locks lexically held at the site;
- **thread roles** propagate from declared roots (``# keplint:
  thread-role=<role>`` on a def or class, ``hot-loop`` markers, and
  callables passed to a ``# keplint: role-registrar=<role>`` function
  such as ``APIServer.register``) along call edges, stopping at
  ``# keplint: role-boundary`` seams (the meter keeps its own
  contract);
- per-function **lock summaries** (which locks a function acquires,
  directly and through its call closure) feed the KTL111 lock-order
  graph.

The KTL111/112/113 rule families in ``analysis/rules/`` consume this
context; everything here is pure construction, no diagnostics.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Sequence

from kepler_tpu_torch.analysis.engine import FileContext
from kepler_tpu_torch.analysis.rules.common import (
    Imports as _Imports,
    child_bodies as _shared_child_bodies,
    qualname as _qualname,
    stmt_exprs as _shared_stmt_exprs,
)

__all__ = [
    "CallSite",
    "ClassInfo",
    "FunctionInfo",
    "ProjectContext",
]

# attribute names treated as lock acquisitions inside a `with` even when
# the constructor was not seen (over-approximation shared with KTL108)
_LOCKISH = ("lock", "mutex", "cv", "cond")

_LOCK_CTORS = {
    "threading.Lock": "Lock",
    "threading.RLock": "RLock",
    "threading.Condition": "Condition",
    "threading.Semaphore": "Semaphore",
    "threading.BoundedSemaphore": "Semaphore",
}


def module_name_for(rel_path: str) -> str:
    """``kepler_tpu_torch/fleet/wire.py`` → ``kepler_tpu_torch.fleet.wire``;
    ``pkg/__init__.py`` → ``pkg``."""
    parts = rel_path[:-3].split("/") if rel_path.endswith(".py") \
        else rel_path.split("/")
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(p for p in parts if p)


@dataclass
class FunctionInfo:
    """One function/method with everything the project rules inspect."""

    func_id: str                     # "module:Class.method" / "module:func"
    module: str
    qual: str                        # dotted path inside the module
    node: ast.AST                    # FunctionDef | AsyncFunctionDef
    ctx: FileContext
    class_key: str | None = None     # enclosing ClassInfo key
    # locks this function acquires itself: (lock_id, raw_qual, node,
    # frozenset of lock_ids already held at the acquisition)
    acquires: list = field(default_factory=list)
    # attribute-chain assignment targets: (raw_qual, node, held_raw) —
    # KTL111 checks cross-class guarded-attribute writes against these
    writes: list = field(default_factory=list)
    # lock_ids acquired by this function OR anything it calls (fixpoint)
    closure_acquires: frozenset = frozenset()
    # thread roles this function runs under: role → CallSite | None
    # (None = this function is itself a root for the role)
    roles: dict = field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.qual.rsplit(".", 1)[-1]

    def marker(self, kind: str) -> str | None:
        return self.ctx.marker_on(self.node, kind)


@dataclass
class ClassInfo:
    key: str                         # "module:Outer.Inner"
    name: str
    module: str
    node: ast.ClassDef
    ctx: FileContext
    bases: list = field(default_factory=list)         # resolved class keys
    methods: dict = field(default_factory=dict)       # name → func_id
    guarded: dict = field(default_factory=dict)       # attr → lock attr
    attr_types: dict = field(default_factory=dict)    # attr → class key
    lock_kinds: dict = field(default_factory=dict)    # attr → Lock/RLock/…

    def marker(self, kind: str) -> str | None:
        return self.ctx.marker_on(self.node, kind)


@dataclass
class CallSite:
    """One resolved call edge."""

    caller: str                      # func_id
    callee: str                      # func_id
    node: ast.Call
    ctx: FileContext
    # raw receiver qualnames of locks lexically held at the site
    # ("self._lock", "self._agg._lock", …) plus entry-held requires-lock
    held_raw: frozenset = frozenset()
    held_ids: frozenset = frozenset()        # same, as global lock ids
    receiver: str | None = None              # "self._spool" for attr calls


class ProjectContext:
    """Symbol table + call graph + roles over a set of parsed files."""

    def __init__(self, ctxs: Sequence[FileContext]) -> None:
        self.files: dict[str, FileContext] = {c.rel_path: c for c in ctxs}
        self.modules: dict[str, FileContext] = {}
        self.imports: dict[str, _Imports] = {}
        self.functions: dict[str, FunctionInfo] = {}
        self.classes: dict[str, ClassInfo] = {}
        self.calls: dict[str, list[CallSite]] = {}
        self.callers: dict[str, list[CallSite]] = {}
        # containing function of each module: "module:" pseudo-function
        # is NOT modeled; module-level calls are ignored (import-time)
        for ctx in ctxs:
            mod = module_name_for(ctx.rel_path)
            self.modules[mod] = ctx
            self.imports[ctx.rel_path] = _Imports(ctx.tree)
        for ctx in ctxs:
            self._collect_symbols(ctx)
        for ctx in ctxs:
            self._infer_types(ctx)
        for info in list(self.functions.values()):
            self._link_calls(info)
        self._close_lock_acquires()
        self._propagate_roles()

    # -- symbol collection -------------------------------------------------

    def _collect_symbols(self, ctx: FileContext) -> None:
        mod = module_name_for(ctx.rel_path)

        def visit(node: ast.AST, path: tuple[str, ...],
                  class_key: str | None) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    key = f"{mod}:{'.'.join(path + (child.name,))}"
                    info = ClassInfo(key=key, name=child.name, module=mod,
                                     node=child, ctx=ctx)
                    self.classes[key] = info
                    visit(child, path + (child.name,), key)
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    qual = ".".join(path + (child.name,))
                    fid = f"{mod}:{qual}"
                    self.functions[fid] = FunctionInfo(
                        func_id=fid, module=mod, qual=qual, node=child,
                        ctx=ctx, class_key=class_key)
                    if class_key is not None:
                        self.classes[class_key].methods.setdefault(
                            child.name, fid)
                    # nested defs: new scope, not a method of class_key
                    visit(child, path + (child.name,), None)

        visit(ctx.tree, (), None)

    # -- type inference ----------------------------------------------------

    def resolve_class(self, ctx: FileContext, name: str | None) -> str | None:
        """Class key for a (possibly dotted / imported / aliased) name
        as seen from ``ctx``."""
        if not name:
            return None
        mod = module_name_for(ctx.rel_path)
        # local (top-level or nested) class of this module
        for key in (f"{mod}:{name}",):
            if key in self.classes:
                return key
        canon = self.imports[ctx.rel_path].canonical(name)
        if canon and "." in canon:
            owner, _, cls = canon.rpartition(".")
            key = f"{owner}:{cls}"
            if key in self.classes:
                return key
        return None

    def _annotation_class(self, ctx: FileContext,
                          ann: ast.AST | None) -> str | None:
        if ann is None:
            return None
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            try:
                ann = ast.parse(ann.value, mode="eval").body
            except SyntaxError:
                return None
        # unwrap Optional[X] / "X | None"
        if isinstance(ann, ast.Subscript):
            base = _qualname(ann.value) or ""
            if base.rsplit(".", 1)[-1] == "Optional":
                ann = ann.slice
            else:
                return None
        if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
            left = self._annotation_class(ctx, ann.left)
            return left or self._annotation_class(ctx, ann.right)
        qual = _qualname(ann)
        if qual in ("None", "NoneType"):
            return None
        return self.resolve_class(ctx, qual)

    def _infer_types(self, ctx: FileContext) -> None:
        """Fill ClassInfo.attr_types / lock_kinds / guarded / bases."""
        for cls in self.classes.values():
            if cls.ctx is not ctx:
                continue
            for base in cls.node.bases:
                key = self.resolve_class(ctx, _qualname(base))
                if key:
                    cls.bases.append(key)
            for fid in cls.methods.values():
                fn = self.functions[fid].node
                for stmt in ast.walk(fn):
                    if isinstance(stmt, ast.AnnAssign):
                        target, value = stmt.target, stmt.value
                        tkey = self._annotation_class(ctx, stmt.annotation)
                    elif isinstance(stmt, ast.Assign) \
                            and len(stmt.targets) == 1:
                        target, value = stmt.targets[0], stmt.value
                        tkey = None
                    else:
                        continue
                    if not (isinstance(target, ast.Attribute)
                            and isinstance(target.value, ast.Name)
                            and target.value.id == "self"):
                        continue
                    attr = target.attr
                    if isinstance(value, ast.Call):
                        canon = self.imports[ctx.rel_path].canonical(
                            _qualname(value.func))
                        if canon in _LOCK_CTORS:
                            cls.lock_kinds.setdefault(
                                attr, _LOCK_CTORS[canon])
                        tkey = tkey or self.resolve_class(
                            ctx, _qualname(value.func))
                    elif isinstance(value, ast.Name):
                        tkey = tkey or self._param_type(fid, value.id)
                    if tkey:
                        cls.attr_types.setdefault(attr, tkey)
                    # guarded-by directives attach to the assignment line
                    for kind, arg in ctx.directives.get(stmt.lineno, []):
                        if kind == "guarded-by" and arg:
                            cls.guarded.setdefault(attr, arg)

    def _param_type(self, fid: str, name: str) -> str | None:
        info = self.functions.get(fid)
        if info is None:
            return None
        args = info.node.args
        for a in (list(args.posonlyargs) + list(args.args)
                  + list(args.kwonlyargs)):
            if a.arg == name:
                return self._annotation_class(info.ctx, a.annotation)
        return None

    # -- lookup helpers ----------------------------------------------------

    def class_of(self, info: FunctionInfo) -> ClassInfo | None:
        return self.classes.get(info.class_key) if info.class_key else None

    def method_on(self, class_key: str | None,
                  name: str, _seen: frozenset = frozenset()) -> str | None:
        """Method resolution through project-visible single inheritance."""
        if not class_key or class_key in _seen:
            return None
        cls = self.classes.get(class_key)
        if cls is None:
            return None
        if name in cls.methods:
            return cls.methods[name]
        for base in cls.bases:
            fid = self.method_on(base, name, _seen | {class_key})
            if fid:
                return fid
        return None

    def guarded_on(self, class_key: str | None, attr: str,
                   _seen: frozenset = frozenset()) -> str | None:
        """guarded-by lock attr for ``attr`` looked up through bases."""
        if not class_key or class_key in _seen:
            return None
        cls = self.classes.get(class_key)
        if cls is None:
            return None
        if attr in cls.guarded:
            return cls.guarded[attr]
        for base in cls.bases:
            lock = self.guarded_on(base, attr, _seen | {class_key})
            if lock:
                return lock
        return None

    def class_marker(self, class_key: str | None, kind: str,
                     _seen: frozenset = frozenset()) -> str | None:
        if not class_key or class_key in _seen:
            return None
        cls = self.classes.get(class_key)
        if cls is None:
            return None
        val = cls.marker(kind)
        if val is not None:
            return val
        for base in cls.bases:
            val = self.class_marker(base, kind, _seen | {class_key})
            if val is not None:
                return val
        return None

    def local_types(self, info: FunctionInfo) -> dict[str, str]:
        """name → class key for annotated params and constructor-assigned
        locals of one function."""
        out: dict[str, str] = {}
        args = info.node.args
        for a in (list(args.posonlyargs) + list(args.args)
                  + list(args.kwonlyargs)):
            key = self._annotation_class(info.ctx, a.annotation)
            if key:
                out[a.arg] = key
        for stmt in ast.walk(info.node):
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name) \
                    and isinstance(stmt.value, ast.Call):
                key = self.resolve_class(info.ctx,
                                         _qualname(stmt.value.func))
                if key:
                    out.setdefault(stmt.targets[0].id, key)
        return out

    def resolve_call(self, info: FunctionInfo, call: ast.Call,
                     local_types: dict[str, str]) -> tuple[str | None,
                                                           str | None]:
        """(callee func_id, receiver qual) for one call, or (None, None).

        Resolution order: ``self.m()`` through the enclosing class (and
        bases), ``self.attr.m()`` / ``local.m()`` through inferred
        types, ``Class(...)`` to ``__init__``, plain/imported names to
        module functions, ``mod.func()`` through the alias map.
        """
        func = call.func
        mod = info.module
        if isinstance(func, ast.Name):
            name = func.id
            key = self.resolve_class(info.ctx, name)
            if key:
                return self.method_on(key, "__init__"), None
            fid = f"{mod}:{name}"
            if fid in self.functions:
                return fid, None
            canon = self.imports[info.ctx.rel_path].canonical(name)
            if canon and "." in canon:
                owner, _, fn_name = canon.rpartition(".")
                fid = f"{owner}:{fn_name}"
                if fid in self.functions:
                    return fid, None
            return None, None
        if not isinstance(func, ast.Attribute):
            return None, None
        attr = func.attr
        recv_qual = _qualname(func.value)
        if recv_qual == "self" and info.class_key:
            return self.method_on(info.class_key, attr), "self"
        if recv_qual:
            parts = recv_qual.split(".")
            # self.attr chains: resolve the attribute's inferred type
            if parts[0] == "self" and len(parts) == 2 and info.class_key:
                cls = self.class_of(info)
                tkey = self._attr_type_on(info.class_key, parts[1]) \
                    if cls else None
                if tkey:
                    return self.method_on(tkey, attr), recv_qual
                return None, recv_qual
            if len(parts) == 1:
                tkey = local_types.get(parts[0])
                if tkey:
                    return self.method_on(tkey, attr), recv_qual
                # ClassName.method / module.func / imported alias
                key = self.resolve_class(info.ctx, parts[0])
                if key:
                    return self.method_on(key, attr), None
            canon = self.imports[info.ctx.rel_path].canonical(recv_qual)
            if canon:
                fid = f"{canon}:{attr}"
                if fid in self.functions:
                    return fid, None
                key = self.resolve_class(info.ctx, recv_qual)
                if key:
                    return self.method_on(key, attr), None
        return None, recv_qual

    def _attr_type_on(self, class_key: str | None, attr: str,
                      _seen: frozenset = frozenset()) -> str | None:
        if not class_key or class_key in _seen:
            return None
        cls = self.classes.get(class_key)
        if cls is None:
            return None
        if attr in cls.attr_types:
            return cls.attr_types[attr]
        for base in cls.bases:
            tkey = self._attr_type_on(base, attr, _seen | {class_key})
            if tkey:
                return tkey
        return None

    # -- lock identity -----------------------------------------------------

    def lock_id(self, info: FunctionInfo, raw_qual: str) -> str:
        """Global identity of a lock named by ``raw_qual`` in ``info``:
        ``self._lock`` keys on the (attribute-typed) owning class so the
        same lock has one node in the order graph regardless of which
        method or module acquires it."""
        parts = raw_qual.split(".")
        if parts[0] == "self" and info.class_key:
            if len(parts) == 2:
                owner = self._lock_owner(info.class_key, parts[1])
                return f"{owner}.{parts[1]}"
            if len(parts) == 3:
                tkey = self._attr_type_on(info.class_key, parts[1])
                if tkey:
                    owner = self._lock_owner(tkey, parts[2])
                    return f"{owner}.{parts[2]}"
            return f"{info.class_key}.{'.'.join(parts[1:])}"
        if len(parts) == 1:
            # module-level lock, or a local variable (function-scoped id)
            ctx = info.ctx
            for node in ctx.tree.body:
                if isinstance(node, ast.Assign) and any(
                        isinstance(t, ast.Name) and t.id == parts[0]
                        for t in node.targets):
                    return f"{info.module}:{parts[0]}"
            return f"{info.func_id}:{parts[0]}"
        return f"{info.module}:{raw_qual}"

    def _lock_owner(self, class_key: str, lock_attr: str) -> str:
        """Hoist a lock's identity to the base class that creates it, so
        subclass acquisitions alias correctly."""
        cls = self.classes.get(class_key)
        if cls is None:
            return class_key
        if lock_attr in cls.lock_kinds:
            return class_key
        for base in cls.bases:
            owner = self._lock_owner(base, lock_attr)
            owner_cls = self.classes.get(owner)
            if owner_cls is not None and lock_attr in owner_cls.lock_kinds:
                return owner
        return class_key

    def lock_kind(self, lock_id: str) -> str | None:
        """Lock/RLock/Condition/… when the constructor was seen."""
        owner, _, attr = lock_id.rpartition(".")
        cls = self.classes.get(owner)
        if cls is not None:
            return cls.lock_kinds.get(attr)
        return None

    @staticmethod
    def is_lockish(info_or_none: "ProjectContext | None",
                   raw_qual: str) -> bool:
        term = raw_qual.rsplit(".", 1)[-1].lower()
        return any(t in term for t in _LOCKISH)

    def _with_lock_quals(self, info: FunctionInfo,
                         node: ast.With) -> list[tuple[str, ast.AST]]:
        out: list[tuple[str, ast.AST]] = []
        for item in node.items:
            qual = _qualname(item.context_expr)
            if not qual:
                continue
            term = qual.rsplit(".", 1)[-1].lower()
            known = False
            parts = qual.split(".")
            if parts[0] == "self" and info.class_key:
                if len(parts) == 2 and self._lock_kind_on(
                        info.class_key, parts[1]):
                    known = True
                elif len(parts) == 3:
                    tkey = self._attr_type_on(info.class_key, parts[1])
                    if tkey and self._lock_kind_on(tkey, parts[2]):
                        known = True
            if known or any(t in term for t in _LOCKISH):
                out.append((qual, item.context_expr))
        return out

    def _lock_kind_on(self, class_key: str, attr: str,
                      _seen: frozenset = frozenset()) -> str | None:
        if class_key in _seen:
            return None
        cls = self.classes.get(class_key)
        if cls is None:
            return None
        if attr in cls.lock_kinds:
            return cls.lock_kinds[attr]
        for base in cls.bases:
            kind = self._lock_kind_on(base, attr, _seen | {class_key})
            if kind:
                return kind
        return None

    # -- call graph + lock walk --------------------------------------------

    def _link_calls(self, info: FunctionInfo) -> None:
        local_types = self.local_types(info)
        sites: list[CallSite] = []
        entry_raw: set[str] = set()
        req = info.marker("requires-lock")
        if req:
            entry_raw.add(f"self.{req}")

        def walk(stmts: list, held_raw: frozenset,
                 held_ids: frozenset) -> None:
            for stmt in stmts:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                    continue  # separate functions; no lexical lock carry
                add_raw: set[str] = set()
                add_ids: set[str] = set()
                if isinstance(stmt, ast.With):
                    for qual, expr in self._with_lock_quals(info, stmt):
                        lid = self.lock_id(info, qual)
                        info.acquires.append((lid, qual, expr, held_ids))
                        add_raw.add(qual)
                        add_ids.add(lid)
                # attribute writes (guarded-by enforcement feeds on these)
                targets: list = []
                if isinstance(stmt, ast.Assign):
                    targets = list(stmt.targets)
                elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
                    targets = [stmt.target]
                for target in targets:
                    inner = target
                    while isinstance(inner, ast.Subscript):
                        inner = inner.value
                    qual = _qualname(inner)
                    if qual and "." in qual:
                        info.writes.append(
                            (qual, stmt,
                             held_raw | frozenset(add_raw)))
                # calls in THIS statement's own expressions
                for expr in self._stmt_exprs(stmt):
                    if isinstance(expr, ast.Call):
                        callee, recv = self.resolve_call(
                            info, expr, local_types)
                        if callee and callee in self.functions:
                            sites.append(CallSite(
                                caller=info.func_id, callee=callee,
                                node=expr, ctx=info.ctx,
                                held_raw=held_raw | frozenset(add_raw),
                                held_ids=held_ids | frozenset(add_ids),
                                receiver=recv))
                for body in self._child_bodies(stmt):
                    walk(body, held_raw | frozenset(add_raw),
                         held_ids | frozenset(add_ids))

        entry_ids = frozenset(self.lock_id(info, q) for q in entry_raw)
        walk(list(info.node.body), frozenset(entry_raw), entry_ids)
        self.calls[info.func_id] = sites
        for site in sites:
            self.callers.setdefault(site.callee, []).append(site)

    _stmt_exprs = staticmethod(_shared_stmt_exprs)
    _child_bodies = staticmethod(_shared_child_bodies)

    def _close_lock_acquires(self) -> None:
        """closure_acquires: lock ids acquired by a function or anything
        reachable from it (worklist fixpoint, cycle-safe)."""
        own = {fid: frozenset(a[0] for a in info.acquires)
               for fid, info in self.functions.items()}
        closure = dict(own)
        changed = True
        iters = 0
        while changed and iters < 50:
            changed = False
            iters += 1
            for fid, sites in self.calls.items():
                acc = closure[fid]
                for site in sites:
                    acc = acc | closure.get(site.callee, frozenset())
                if acc != closure[fid]:
                    closure[fid] = acc
                    changed = True
        for fid, info in self.functions.items():
            info.closure_acquires = closure[fid]

    # -- thread roles ------------------------------------------------------

    def _propagate_roles(self) -> None:
        roots: list[tuple[str, str]] = []  # (func_id, role)
        for fid, info in self.functions.items():
            if info.marker("hot-loop") is not None:
                roots.append((fid, "hot-loop"))
            role = info.marker("thread-role")
            if role:
                roots.append((fid, role))
            crole = self.class_marker(info.class_key, "thread-role")
            if crole and info.name != "__init__":
                roots.append((fid, crole))
        # role-registrar: callables passed to a registrar become roots
        for fid, info in self.functions.items():
            role = info.marker("role-registrar")
            if not role:
                continue
            for site in self.callers.get(fid, []):
                caller = self.functions[site.caller]
                ltypes = self.local_types(caller)
                for arg in list(site.node.args) + [
                        kw.value for kw in site.node.keywords]:
                    target = self._callable_arg(caller, arg, ltypes)
                    if target:
                        roots.append((target, role))
        # BFS per role with parent pointers for chain reconstruction
        queue: list[str] = []
        for fid, role in roots:
            info = self.functions[fid]
            if role not in info.roles:
                info.roles[role] = None
                queue.append(fid)
        while queue:
            fid = queue.pop()
            info = self.functions[fid]
            for site in self.calls.get(fid, []):
                callee = self.functions[site.callee]
                if callee.marker("role-boundary") is not None:
                    continue  # the seam keeps its own contract
                grew = False
                for role in info.roles:
                    if role not in callee.roles:
                        callee.roles[role] = site
                        grew = True
                if grew:
                    queue.append(site.callee)

    def _callable_arg(self, caller: FunctionInfo, arg: ast.AST,
                      local_types: dict[str, str]) -> str | None:
        """func_id of a function-valued argument (``self._handle`` or a
        plain function name)."""
        qual = _qualname(arg)
        if not qual:
            return None
        parts = qual.split(".")
        if parts[0] == "self" and len(parts) == 2 and caller.class_key:
            return self.method_on(caller.class_key, parts[1])
        if len(parts) == 1:
            fid = f"{caller.module}:{parts[0]}"
            if fid in self.functions:
                return fid
            canon = self.imports[caller.ctx.rel_path].canonical(parts[0])
            if canon and "." in canon:
                owner, _, name = canon.rpartition(".")
                fid = f"{owner}:{name}"
                if fid in self.functions:
                    return fid
        if len(parts) == 2:
            tkey = local_types.get(parts[0])
            if tkey:
                return self.method_on(tkey, parts[1])
        return None

    def role_chain(self, fid: str, role: str, limit: int = 12) -> list[str]:
        """Human-readable call chain from the role root down to ``fid``."""
        chain: list[str] = []
        cur: str | None = fid
        while cur is not None and len(chain) < limit:
            info = self.functions[cur]
            chain.append(info.qual)
            site = info.roles.get(role)
            cur = site.caller if site is not None else None
        chain.reverse()
        return chain
