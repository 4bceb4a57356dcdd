"""Container detection from cgroup paths.

Reference parity: ``internal/resource/container.go`` — regex over
``/proc/<pid>/cgroup`` paths for 7 runtime patterns (:14-25), choosing the
*deepest* (most path components) match (:92-141); container name from
HOSTNAME / CONTAINER_NAME env (:144-159) or ``--name`` in cmdline (:162-190).
"""

from __future__ import annotations

import re

from kepler_tpu_torch.resource.types import Container, ContainerRuntime
from kepler_tpu_torch.resource.procfs import ProcInfo

# (pattern, runtime) in reference order (container.go:14-40).
_PATTERNS: list[tuple[re.Pattern[str], ContainerRuntime]] = [
    (re.compile(r"/docker[-/]([0-9a-f]{64})"), ContainerRuntime.DOCKER),
    (re.compile(r"/containerd[-/]([0-9a-f]{64})"), ContainerRuntime.CONTAINERD),
    (re.compile(r"[:/]cri-containerd[-:]([0-9a-f]{64})"),
     ContainerRuntime.CONTAINERD),
    (re.compile(r"/crio-([0-9a-f]{64})"), ContainerRuntime.CRIO),
    (re.compile(r"libpod-([0-9a-f]{64})"), ContainerRuntime.PODMAN),
    (re.compile(r"/libpod-payload-([0-9a-f]+)"), ContainerRuntime.PODMAN),
    (re.compile(r"/kubepods/[^/]+/pod[0-9a-f\-]+/([0-9a-f]{64})"),
     ContainerRuntime.KUBEPODS),
]

# Cheap PREFILTER: one alternation (group-free, patterns verbatim) that
# matches iff ANY runtime pattern would. The per-pattern deepest-match
# loop below is exact but ~7 scans per path; most processes on a real
# node are NOT containers, and a burst of new system procs classifies in
# one combined scan each. A single left-to-right alternation cannot
# REPLACE the loop — a long early match (kubepods) would consume the
# span and hide a deeper-starting inner match (libpod nested inside) —
# so it only gates it.
_PREFILTER = re.compile("|".join(f"(?:{p.pattern})" for p, _ in _PATTERNS))


def container_info_from_cgroup_paths(
    paths: list[str],
) -> tuple[ContainerRuntime, str]:
    """Return (runtime, container_id) of the deepest match.

    Deepest = highest match start index, across ALL matches in all paths —
    systemd nesting (kind-in-docker) puts the leaf container scope after
    its host's, so the later match identifies the process (reference
    container.go:92-141 sorts by StartIdx descending).
    """
    best: tuple[int, ContainerRuntime, str] | None = None
    for path in paths:
        if _PREFILTER.search(path) is None:
            continue
        for pattern, runtime in _PATTERNS:
            for m in pattern.finditer(path):
                if best is None or m.start() > best[0]:
                    best = (m.start(), runtime, m.group(1))
    if best is None:
        return ContainerRuntime.UNKNOWN, ""
    return best[1], best[2]


def _name_from_env(env: dict[str, str]) -> str:
    # CONTAINER_NAME beats HOSTNAME (reference container.go:144-159)
    if env.get("CONTAINER_NAME"):
        return env["CONTAINER_NAME"]
    return env.get("HOSTNAME", "")


def _name_from_cmdline(cmdline: list[str]) -> str:
    # docker/podman runtimes pass --name <name> or --name=<name>; the
    # containerd shims pass the container name positionally as argv[3]
    # (reference container.go:162-190)
    if len(cmdline) <= 1:
        return ""
    exe = cmdline[0].rsplit("/", 1)[-1]
    shim = exe in ("docker-containerd-shim", "containerd-shim")
    for i, arg in enumerate(cmdline):
        if i > 0:
            if arg == "--name" and i + 1 < len(cmdline):
                return cmdline[i + 1]
            if arg.startswith("--name="):
                return arg.split("=", 1)[1]
        if shim and i == 3:
            return arg
    return ""


def container_name(env: dict[str, str], cmdline: list[str],
                   container_id: str) -> str:
    """Resolve a container's display name: env beats cmdline beats the
    id-prefix fallback (reference container.go:144-190)."""
    name = _name_from_env(env)
    if not name:
        name = _name_from_cmdline(cmdline)
    return name or container_id[:12]


def container_info_from_proc(proc: ProcInfo) -> Container | None:
    """Detect containment; None when the process isn't in a container."""
    try:
        paths = proc.cgroups()
    except OSError:
        return None
    if not paths:
        return None
    runtime, container_id = container_info_from_cgroup_paths(paths)
    if not container_id:
        return None
    env: dict[str, str] = {}
    cmdline: list[str] = []
    try:
        env = proc.environ()
    except OSError:
        pass
    try:
        cmdline = proc.cmdline()
    except OSError:
        pass
    return Container(id=container_id,
                     name=container_name(env, cmdline, container_id),
                     runtime=runtime)
