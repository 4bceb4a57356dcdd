"""KTL113 — thread-role discipline (whole-program).

Thread roles are declared at the roots (``# keplint: thread-role=<role>``
on a def or class; the ``hot-loop`` marker roots the ``hot-loop`` role;
callables registered through a ``# keplint: role-registrar=<role>``
function — ``APIServer.register`` — root the ``http-handler`` role) and
propagate along resolved call edges, stopping at ``# keplint:
role-boundary`` seams. Two disciplines are enforced on top:

- **hot-loop reachability**: a blocking call any number of frames below
  a hot-loop root stalls the refresh cadence exactly like a lexical one
  (KTL106 generalized through the call graph);
- **handler isolation**: classes marked ``# keplint:
  forbid-role=http-handler`` (the live window engines) may not be
  called from HTTP-handler-role code except through methods marked
  ``# keplint: allow-role=http-handler`` — pinning the invariant
  that handlers read *published snapshots*, never live engine state.
"""

from __future__ import annotations

import ast
from typing import Iterable, Iterator

from kepler_tpu_torch.analysis.engine import Diagnostic, ProjectRule, register
from kepler_tpu_torch.analysis.rules.common import imports_for, is_blocking_call

_HOT_ROLE = "hot-loop"


def _roles_in(arg: str | None) -> set[str]:
    if not arg:
        return set()
    return {p.strip() for p in arg.split(",") if p.strip()}


@register
class ThreadRoleRule(ProjectRule):
    id = "KTL113"
    name = "thread-role"
    summary = ("no blocking calls reachable from hot-loop roots through "
               "any call chain, and HTTP-handler-role code stays off "
               "classes marked `forbid-role=http-handler` except via "
               "`allow-role` accessors")
    rationale = (
        "KTL106 sees a sleep inside a marked function; it is blind to "
        "the same sleep one helper call away — and the refresh loop "
        "stalls identically either way. KTL113 propagates thread roles "
        "from declared roots (refresh loop, agent thread, ingest and "
        "debug HTTP handlers, _FetchWorker, shutdown paths) along the "
        "project call graph, stopping at `role-boundary` seams (the "
        "meter does I/O by design), and flags blocking calls reachable "
        "under the hot-loop role with the full call chain. It also pins "
        "the introspection invariant: HTTP handler threads serve "
        "PUBLISHED snapshots; one refactor that reaches live engine "
        "state (classes marked forbid-role=http-handler) is a data race "
        "with the pipelined window thread, caught here at the call edge.")

    def check_project(self, project) -> Iterable[Diagnostic]:
        yield from self._check_hot_reachability(project)
        yield from self._check_forbidden(project)

    def _check_hot_reachability(self, project) -> Iterator[Diagnostic]:
        for info in project.functions.values():
            if _HOT_ROLE not in info.roles:
                continue
            if info.marker("hot-loop") is not None:
                continue  # a root: KTL106's lexical tier owns it
            imports = imports_for(info.ctx)
            for node in ast.walk(info.node):
                if not isinstance(node, ast.Call):
                    continue
                canon = is_blocking_call(node, imports)
                if not canon:
                    continue
                chain = project.role_chain(info.func_id, _HOT_ROLE)
                yield info.ctx.diag(
                    self, node,
                    f"blocking call {canon}() in {info.qual}() is "
                    "reachable from a hot-loop root via "
                    f"{' → '.join(chain)}; the refresh path must not "
                    "sleep or do I/O beyond the meter seam "
                    "(role-boundary)")

    def _check_forbidden(self, project) -> Iterator[Diagnostic]:
        for sites in project.calls.values():
            for site in sites:
                callee = project.functions[site.callee]
                forbidden = _roles_in(project.class_marker(
                    callee.class_key, "forbid-role"))
                if not forbidden:
                    continue
                caller = project.functions[site.caller]
                hit = forbidden & set(caller.roles)
                if not hit:
                    continue
                allowed = _roles_in(callee.marker("allow-role"))
                hit -= allowed
                # a constructor call is wiring, not state access
                if callee.name == "__init__":
                    continue
                for role in sorted(hit):
                    chain = project.role_chain(caller.func_id, role)
                    yield site.ctx.diag(
                        self, site.node,
                        f"{role}-role code ({' → '.join(chain)}) calls "
                        f"{callee.qual}() on a class marked "
                        f"forbid-role={role}; reach this state only "
                        "through its published-snapshot accessors "
                        "(mark the method allow-role to sanction)")
