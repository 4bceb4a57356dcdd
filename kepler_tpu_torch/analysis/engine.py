"""keplint engine: AST lint with a rule registry and a baseline ratchet.

The attribution formula is only correct while a handful of code-level
invariants hold everywhere (wrap-aware counter deltas, monotonic clocks in
timing logic, immutable published snapshots, pure jitted kernels, …).
``ruff``/``mypy`` cannot see those — they are *domain* invariants — so this
module is a small, self-contained AST lint engine that can:

- run a registry of :class:`Rule` objects over a file tree
  (:func:`lint_paths`);
- honor inline suppressions (``# keplint: disable=KTL101`` on the
  offending line or the comment line above it, ``# keplint:
  disable-file=KTL101`` anywhere in the file);
- carry per-file/per-function *markers* that scope rules declaratively
  (``# keplint: monotonic-only``, ``# keplint: hot-loop``,
  ``# keplint: guarded-by=_lock`` — see the ``rules/`` package);
- freeze existing violations in a committed baseline so new ones fail
  while old ones ratchet down (:class:`Baseline`), mirroring the
  strict-typing ratchet in ``pyproject.toml``.

No third-party dependencies: stdlib ``ast`` only, so the AST tiers run
in every container the tests run in. This is the port's own copy of the
reference package's engine, scoped to ``kepler_tpu_torch``.
"""

from __future__ import annotations

import ast
import io
import json
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Iterable, Iterator, Sequence

__all__ = [
    "Baseline",
    "DeviceRule",
    "Diagnostic",
    "FileContext",
    "LintResult",
    "ProjectRule",
    "ProtocolRule",
    "REGISTRY",
    "Rule",
    "build_file_context",
    "find_repo_root",
    "lint_paths",
    "register",
]

SEVERITY_ERROR = "error"
SEVERITY_WARNING = "warning"

# the trees whose membership means anything for rule scoping; paths
# outside them are always fully linted (see Rule.in_scope)
SCOPED_TREES = ("kepler_tpu_torch", "hack", "benchmarks")

# one directive grammar for suppressions AND rule markers; parsed once per
# file so rules never re-scan source text.  The whole-program vocabulary
# (thread-role, taint-*, sanitizes, …) is consumed by analysis/project.py
# and the KTL111-113 rule family.
_DIRECTIVE = re.compile(
    r"#\s*keplint:\s*"
    r"(?P<kind>disable-file|disable|monotonic-only|hot-loop|"
    r"guarded-by|requires-lock|donates|layout-definition|"
    r"thread-role|role-boundary|role-registrar|forbid-role|allow-role|"
    r"taint-source|taint-sink|sanitizes|protocol-transition)"
    r"(?:=(?P<arg>[A-Za-z0-9_,\- ]+))?")


@dataclass(frozen=True, order=True)
class Diagnostic:
    """One finding, stable-ordered for deterministic output."""

    path: str  # repo-relative, posix separators
    line: int
    col: int
    rule_id: str
    severity: str
    message: str

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.rule_id} [{self.severity}] {self.message}")

    @property
    def baseline_key(self) -> str:
        return f"{self.path}::{self.rule_id}"


class FileContext:
    """Everything a rule may inspect about one file.

    ``rel_path`` uses posix separators relative to the lint root so rule
    scoping and baselines are machine-independent.
    """

    def __init__(self, path: str, rel_path: str, source: str,
                 tree: ast.Module, root: str = "") -> None:
        self.path = os.path.abspath(path)
        self.rel_path = rel_path
        self.source = source
        self.tree = tree
        self.root = os.path.abspath(root) if root else os.path.dirname(
            self.path)
        self.lines: list[str] = source.splitlines()
        self._walk_nodes: list[ast.AST] | None = None
        # line (1-based) → [(kind, arg-or-None)]; directives come from
        # real COMMENT tokens only, so a docstring QUOTING a directive
        # (this one included) never arms or disarms anything
        self.directives: dict[int, list[tuple[str, str | None]]] = {}
        self.file_directives: set[tuple[str, str | None]] = set()
        for lineno, comment in _iter_comments(source):
            for m in _DIRECTIVE.finditer(comment):
                kind = m.group("kind")
                arg = m.group("arg")
                arg = arg.strip() if arg else None
                self.directives.setdefault(lineno, []).append((kind, arg))
                if kind in ("disable-file", "monotonic-only"):
                    self.file_directives.add((kind, arg))

    @property
    def walk_nodes(self) -> list[ast.AST]:
        """Every AST node of the file, in ``ast.walk`` order, computed
        once and shared by all rules — the tree is walked once per RUN,
        not once per rule (the dominant cost of the old engine)."""
        if self._walk_nodes is None:
            self._walk_nodes = list(ast.walk(self.tree))
        return self._walk_nodes

    # -- marker helpers (rules call these) ---------------------------------

    def has_file_marker(self, kind: str) -> bool:
        return any(k == kind for k, _ in self.file_directives)

    def marker_on(self, node: ast.AST, kind: str) -> str | None:
        """Directive attached to a statement: on its first line, in the
        contiguous comment block above it, or on any decorator line.
        Returns the directive arg ('' when bare)."""
        lines = {node.lineno}
        for deco in getattr(node, "decorator_list", []):
            lines.add(deco.lineno)
        # walk the comment block directly above the statement (or its
        # first decorator) so several markers can stack one per line
        top = min(lines)
        ln = top - 1
        while 0 < ln <= len(self.lines) and \
                self.lines[ln - 1].strip().startswith("#"):
            lines.add(ln)
            ln -= 1
        for ln in lines:
            for kind_, arg in self.directives.get(ln, []):
                if kind_ == kind:
                    return arg or ""
        return None

    def diag(self, rule: "Rule", node: ast.AST, message: str) -> Diagnostic:
        return Diagnostic(
            path=self.rel_path,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0) + 1,
            rule_id=rule.id,
            severity=rule.severity,
            message=message,
        )

    # -- suppression -------------------------------------------------------

    def _disabled_rules_at(self, line: int) -> set[str]:
        out: set[str] = set()
        for kind, arg in self.directives.get(line, []):
            if kind == "disable":
                out |= _parse_rule_list(arg)
        return out

    def suppressed(self, diag: Diagnostic) -> bool:
        for kind, arg in self.file_directives:
            if kind == "disable-file":
                ids = _parse_rule_list(arg)
                if "all" in ids or diag.rule_id in ids:
                    return True
        for line in (diag.line, diag.line - 1):
            ids = self._disabled_rules_at(line)
            if not ids:
                continue
            # a same-line directive always applies; a directive on the
            # previous line applies only when that line is comment-only
            if line != diag.line:
                stripped = (self.lines[line - 1].strip()
                            if 0 < line <= len(self.lines) else "")
                if not stripped.startswith("#"):
                    continue
            if "all" in ids or diag.rule_id in ids:
                return True
        return False


def _iter_comments(source: str) -> Iterator[tuple[int, str]]:
    """(lineno, text) for every comment token; tolerant of files whose
    tail fails tokenization (the AST parse already gated syntax)."""
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                yield tok.start[0], tok.string
    except (tokenize.TokenError, IndentationError):
        return


def _parse_rule_list(arg: str | None) -> set[str]:
    if not arg:
        return {"all"}
    return {part.strip() for part in arg.split(",") if part.strip()}


class Rule:
    """Base class: subclass, set the class attributes, decorate with
    :func:`register`, implement :meth:`check`."""

    id: str = "KTL000"
    name: str = "unnamed"
    severity: str = SEVERITY_ERROR
    summary: str = ""
    rationale: str = ""
    # top-level tree segments this rule runs over, relative to the lint
    # root.  The attribution invariants live in the package; rules that
    # also police tooling/bench code widen this deliberately
    # (KTL101/KTL105 extend to hack/ and benchmarks/).
    tree_scope: tuple[str, ...] = ("kepler_tpu_torch",)

    def check(self, ctx: FileContext) -> Iterable[Diagnostic]:
        raise NotImplementedError

    def in_scope(self, rel_path: str) -> bool:
        head = rel_path.split("/", 1)[0]
        # scoping only partitions the KNOWN trees (hack/ and benchmarks/
        # get a curated rule subset); a path outside all of them — an
        # explicitly linted test file, a scratch script — gets every
        # rule, matching the pre-scoping behavior (a silent all-clear on
        # an explicit path would be a false negative)
        if head not in SCOPED_TREES:
            return True
        return head in self.tree_scope


class ProjectRule(Rule):
    """A rule that needs the whole program: runs once per lint over a
    :class:`~kepler_tpu_torch.analysis.project.ProjectContext` (shared ASTs,
    symbol table, call graph, thread roles) instead of once per file.
    Per-file suppression directives still apply to its diagnostics."""

    def check(self, ctx: FileContext) -> Iterable[Diagnostic]:
        return ()

    def check_project(self, project: "object") -> Iterable[Diagnostic]:
        raise NotImplementedError


class DeviceRule(Rule):
    """A device-tier rule: checks RECORDED runs of the registered device
    programs (``kepler_tpu_torch/analysis/device/``), not source files.
    Runs only when the CLI is invoked with ``--device-tier`` (the runs
    cost real seconds; the per-file tiers stay instant); registered here
    so the catalog, SARIF driver and ``--list-rules`` stay complete."""

    def check(self, ctx: FileContext) -> Iterable[Diagnostic]:
        return ()

    def check_trace(self, report: "object") -> Iterable[Diagnostic]:
        raise NotImplementedError


class ProtocolRule(Rule):
    """A protocol-tier rule: checks the EXPLORED state space of a
    registered protocol model (``kepler_tpu_torch/analysis/protocol/``), not
    source files. The kepmc explorer walks every interleaving of a
    small fleet through the shipped pure transition code and hands each
    rule the exploration report; a counterexample (minimal event trace)
    becomes the diagnostic body. Runs only when the CLI is invoked with
    ``--protocol-tier`` (exhaustive exploration costs real seconds; the
    per-file tiers stay instant); registered here so the catalog, SARIF
    driver and ``--list-rules`` stay complete."""

    def check(self, ctx: FileContext) -> Iterable[Diagnostic]:
        return ()

    def check_model(self, report: "object") -> Iterable[Diagnostic]:
        raise NotImplementedError


REGISTRY: dict[str, Rule] = {}


def register(cls: type) -> type:
    """Class decorator adding one rule instance to the global registry."""
    rule = cls()
    if rule.id in REGISTRY:
        raise ValueError(f"duplicate rule id {rule.id}")
    REGISTRY[rule.id] = rule
    return cls


def all_rules() -> list[Rule]:
    # import deferred so engine/rules have no circular import
    from kepler_tpu_torch.analysis import rules as _rules  # noqa: F401

    return [REGISTRY[rid] for rid in sorted(REGISTRY)]


# ---------------------------------------------------------------------------
# running
# ---------------------------------------------------------------------------


@dataclass
class LintResult:
    """Outcome of one lint run, before/after baseline application."""

    diagnostics: list[Diagnostic] = field(default_factory=list)
    # violations tolerated by the baseline (reported count only)
    baselined: int = 0
    # baseline entries whose violations have (partly) disappeared —
    # the ratchet: regenerate the baseline to lock in the progress
    stale_entries: list[str] = field(default_factory=list)

    @property
    def failed(self) -> bool:
        return any(d.severity == SEVERITY_ERROR for d in self.diagnostics)


def iter_python_files(paths: Sequence[str]) -> Iterator[str]:
    seen: set[str] = set()
    for path in paths:
        if os.path.isfile(path):
            real = os.path.realpath(path)
            if real not in seen and path.endswith(".py"):
                seen.add(real)
                yield path
            continue
        for root, dirs, files in os.walk(path):
            dirs[:] = sorted(d for d in dirs
                             if d not in ("__pycache__", ".git"))
            for f in sorted(files):
                if not f.endswith(".py"):
                    continue
                full = os.path.join(root, f)
                real = os.path.realpath(full)
                if real not in seen:
                    seen.add(real)
                    yield full


def find_repo_root(start: str) -> str:
    """Walk up from ``start`` to the directory holding pyproject.toml —
    relative diagnostic paths and the default baseline live there."""
    cur = os.path.abspath(start if os.path.isdir(start)
                          else os.path.dirname(start) or ".")
    start_dir = cur
    while True:
        if os.path.exists(os.path.join(cur, "pyproject.toml")):
            return cur
        parent = os.path.dirname(cur)
        if parent == cur:
            return start_dir
        cur = parent


def build_file_context(path: str, root: str) -> "FileContext | Diagnostic":
    """Parse one file into a :class:`FileContext` — the single parse every
    rule (per-file and whole-program) shares for the rest of the run.
    Returns a KTL000 :class:`Diagnostic` when the file cannot be parsed."""
    rel = os.path.relpath(os.path.abspath(path), root).replace(os.sep, "/")
    try:
        with open(path, encoding="utf-8") as f:
            source = f.read()
        tree = ast.parse(source, filename=path)
    except (OSError, SyntaxError, ValueError) as err:
        return Diagnostic(path=rel, line=getattr(err, "lineno", 1) or 1,
                          col=1, rule_id="KTL000",
                          severity=SEVERITY_ERROR,
                          message=f"cannot parse: {err}")
    return FileContext(path=path, rel_path=rel, source=source, tree=tree,
                       root=root)


def _check_file(ctx: FileContext, rules: Sequence[Rule]) -> list[Diagnostic]:
    out: list[Diagnostic] = []
    for rule in rules:
        if isinstance(rule, ProjectRule) or not rule.in_scope(ctx.rel_path):
            continue
        for diag in rule.check(ctx):
            if not ctx.suppressed(diag):
                out.append(diag)
    return out


def lint_file(path: str, root: str,
              rules: Sequence[Rule] | None = None) -> list[Diagnostic]:
    """All non-suppressed per-file diagnostics for one file (no baseline,
    no whole-program rules — use :func:`lint_paths` for those)."""
    rules = list(rules) if rules is not None else all_rules()
    ctx = build_file_context(path, root)
    if isinstance(ctx, Diagnostic):
        return [ctx]
    return sorted(_check_file(ctx, rules))


def _check_project(ctxs: Sequence[FileContext],
                   rules: Sequence[Rule]) -> list[Diagnostic]:
    """Run the whole-program rules over one ProjectContext spanning
    ``ctxs`` (already-parsed files — nothing is re-read or re-parsed)."""
    project_rules = [r for r in rules if isinstance(r, ProjectRule)]
    if not project_rules or not ctxs:
        return []
    # deferred import: project.py imports engine types
    from kepler_tpu_torch.analysis.project import ProjectContext

    project = ProjectContext(ctxs)
    by_rel = {ctx.rel_path: ctx for ctx in ctxs}
    out: list[Diagnostic] = []
    for rule in project_rules:
        for diag in rule.check_project(project):
            if not rule.in_scope(diag.path):
                continue
            ctx = by_rel.get(diag.path)
            if ctx is not None and ctx.suppressed(diag):
                continue
            out.append(diag)
    return out


def lint_paths(paths: Sequence[str], root: str | None = None,
               rules: Sequence[Rule] | None = None,
               baseline: "Baseline | None" = None,
               per_file: bool = False) -> LintResult:
    """Lint every .py file under ``paths``; apply ``baseline`` if given.

    Each file is parsed exactly once; the resulting contexts feed both
    the per-file rules and the whole-program (:class:`ProjectRule`)
    analysis.  ``per_file=True`` restricts the whole-program rules to
    one-file ProjectContexts — no cross-module call graph — which is how
    the tests prove the call graph is load-bearing (and what the CLI's
    ``--per-file`` exposes for bisecting findings)."""
    root = root or find_repo_root(paths[0] if paths else ".")
    rules = list(rules) if rules is not None else all_rules()
    diags: list[Diagnostic] = []
    ctxs: list[FileContext] = []
    for path in iter_python_files(paths):
        ctx = build_file_context(path, root)
        if isinstance(ctx, Diagnostic):
            diags.append(ctx)
            continue
        ctxs.append(ctx)
        diags.extend(_check_file(ctx, rules))
    if per_file:
        for ctx in ctxs:
            diags.extend(_check_project([ctx], rules))
    else:
        diags.extend(_check_project(ctxs, rules))
    diags.sort()
    if baseline is None:
        return LintResult(diagnostics=diags)
    return baseline.apply(diags)


# ---------------------------------------------------------------------------
# baseline / ratchet
# ---------------------------------------------------------------------------


class Baseline:
    """Committed violation counts per (file, rule).

    A finding is tolerated while its ``path::rule`` count stays at or
    under the recorded number — so existing debt is frozen, new debt
    fails, and *fixing* debt surfaces the entry as stale (regenerate
    with ``--write-baseline`` to ratchet the ceiling down). Counts, not
    line numbers: unrelated edits that shift lines don't churn the file.
    """

    VERSION = 1

    def __init__(self, counts: dict[str, int] | None = None) -> None:
        self.counts: dict[str, int] = dict(counts or {})

    @classmethod
    def load(cls, path: str) -> "Baseline":
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        if not isinstance(data, dict) or data.get("version") != cls.VERSION:
            raise ValueError(f"unsupported baseline file {path!r}")
        counts = data.get("violations", {})
        if not isinstance(counts, dict) or not all(
                isinstance(k, str) and isinstance(v, int) and v > 0
                for k, v in counts.items()):
            raise ValueError(f"malformed baseline file {path!r}")
        return cls(counts)

    def save(self, path: str) -> None:
        payload = {
            "version": self.VERSION,
            "comment": "keplint ratchet: frozen violation counts per "
                       "path::rule. Fix violations, then regenerate with "
                       "`python -m kepler_tpu_torch.analysis --write-baseline` "
                       "to lower the ceiling. Never raise counts by hand.",
            "violations": {k: self.counts[k] for k in sorted(self.counts)},
        }
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=2, sort_keys=False)
            f.write("\n")

    @classmethod
    def from_diagnostics(cls, diags: Iterable[Diagnostic]) -> "Baseline":
        counts: dict[str, int] = {}
        for d in diags:
            counts[d.baseline_key] = counts.get(d.baseline_key, 0) + 1
        return cls(counts)

    def apply(self, diags: Sequence[Diagnostic]) -> LintResult:
        by_key: dict[str, list[Diagnostic]] = {}
        for d in diags:
            by_key.setdefault(d.baseline_key, []).append(d)
        new: list[Diagnostic] = []
        baselined = 0
        for key, group in by_key.items():
            allowed = self.counts.get(key, 0)
            group.sort()
            baselined += min(allowed, len(group))
            new.extend(group[allowed:])
        stale = sorted(k for k, allowed in self.counts.items()
                       if len(by_key.get(k, [])) < allowed)
        new.sort()
        return LintResult(diagnostics=new, baselined=baselined,
                          stale_entries=stale)
