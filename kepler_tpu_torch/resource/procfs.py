"""/proc filesystem reader.

Reference parity: ``internal/resource/procfs_reader.go`` — a thin interface
over per-PID reads (stat → CPU time, comm, exe, cgroup paths, environ,
cmdline) plus node CPU usage ratio from ``/proc/stat`` deltas
(active = total − idle − iowait, :107-141).

CPU time = (utime + stime) / USER_HZ with USER_HZ = 100 (:73-82).

Implemented with direct file reads (no psutil dependency in the hot path —
one open+read per PID per tick is the dominant host-side cost; see the C
accelerator in ``kepler_tpu_torch.native`` for the batched fast path).
"""

from __future__ import annotations

import os
from typing import Iterable, Protocol

USER_HZ = 100.0


def parse_cgroup_text(text: str) -> list[str]:
    """Cgroup paths from /proc/<pid>/cgroup content (v1 and v2 lines)."""
    paths = []
    for line in text.splitlines():
        # format: hierarchy-ID:controller-list:cgroup-path
        parts = line.split(":", 2)
        if len(parts) == 3 and parts[2]:
            paths.append(parts[2])
    return paths


def parse_environ_bytes(raw: bytes) -> dict[str, str]:
    """Env dict from /proc/<pid>/environ content (NUL-separated)."""
    env: dict[str, str] = {}
    for entry in raw.decode("utf-8", "replace").split("\0"):
        if "=" in entry:
            k, _, v = entry.partition("=")
            env[k] = v
    return env


def parse_cmdline_bytes(raw: bytes) -> list[str]:
    """Argv from /proc/<pid>/cmdline content (NUL-separated)."""
    return [a for a in raw.decode("utf-8", "replace").split("\0") if a]


class ProcInfo(Protocol):
    """Per-process accessor (reference procInfo, procfs_reader.go:18-26)."""

    def pid(self) -> int: ...
    def comm(self) -> str: ...
    def executable(self) -> str: ...
    def cgroups(self) -> list[str]: ...
    def environ(self) -> dict[str, str]: ...
    def cmdline(self) -> list[str]: ...
    def cpu_time(self) -> float: ...


class ProcReader(Protocol):
    """All-process enumerator (reference allProcReader, :90-96)."""

    def all_procs(self) -> Iterable[ProcInfo]: ...
    def cpu_usage_ratio(self) -> float: ...


class ProcFSInfo:
    def __init__(self, procfs: str, pid: int) -> None:
        self._dir = os.path.join(procfs, str(pid))
        self._pid = pid

    def pid(self) -> int:
        return self._pid

    def _read(self, name: str) -> str:
        with open(os.path.join(self._dir, name), "rb") as f:
            return f.read().decode("utf-8", "replace")

    def comm(self) -> str:
        return self._read("comm").strip()

    def executable(self) -> str:
        try:
            return os.readlink(os.path.join(self._dir, "exe"))
        except OSError:
            return ""

    def cgroups(self) -> list[str]:
        """Cgroup paths from /proc/<pid>/cgroup (v1 and v2 lines)."""
        return parse_cgroup_text(self._read("cgroup"))

    def environ(self) -> dict[str, str]:
        try:
            with open(os.path.join(self._dir, "environ"), "rb") as f:
                raw = f.read()
        except OSError:
            return {}
        return parse_environ_bytes(raw)

    def cmdline(self) -> list[str]:
        with open(os.path.join(self._dir, "cmdline"), "rb") as f:
            raw = f.read()
        return parse_cmdline_bytes(raw)

    def cpu_time(self) -> float:
        """(utime + stime) / USER_HZ seconds from /proc/<pid>/stat."""
        raw = self._read("stat")
        # comm may contain spaces/parens; fields resume after the last ')'
        rparen = raw.rfind(")")
        fields = raw[rparen + 2:].split()
        # fields[0] is state (field 3); utime=field 14, stime=field 15
        utime = float(fields[11])
        stime = float(fields[12])
        return (utime + stime) / USER_HZ


class ProcFSReader:
    def __init__(self, procfs: str = "/proc") -> None:
        self._procfs = procfs
        self._prev_stat: tuple[float, float] | None = None  # (active, total)

    def all_procs(self) -> list[ProcFSInfo]:
        procs = []
        for entry in os.listdir(self._procfs):
            if entry.isdigit():
                procs.append(ProcFSInfo(self._procfs, int(entry)))
        return procs

    def _read_stat_totals(self) -> tuple[float, float]:
        """(active, total) jiffies from the aggregate 'cpu' line."""
        with open(os.path.join(self._procfs, "stat"), "rb") as f:
            first = f.readline().decode("ascii")
        parts = first.split()
        if parts[0] != "cpu":
            raise RuntimeError(f"unexpected /proc/stat first line: {first!r}")
        values = [float(v) for v in parts[1:]]
        total = sum(values)
        idle = values[3] if len(values) > 3 else 0.0
        iowait = values[4] if len(values) > 4 else 0.0
        active = total - idle - iowait
        return active, total

    def cpu_usage_ratio(self) -> float:
        """Node active/total ratio over the window since the previous call.

        First call returns 0.0 (no delta yet) — mirrors the reference's
        first-reading semantics (procfs_reader.go:107-141).
        """
        active, total = self._read_stat_totals()
        prev = self._prev_stat
        self._prev_stat = (active, total)
        if prev is None:
            return 0.0
        d_active = active - prev[0]
        d_total = total - prev[1]
        if d_total <= 0:
            return 0.0
        return min(max(d_active / d_total, 0.0), 1.0)
