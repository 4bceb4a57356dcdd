"""Native-accelerated /proc reader.

Same semantics as :class:`kepler_tpu_torch.resource.procfs.ProcFSReader`
(reference ``internal/resource/procfs_reader.go``), but the per-tick hot
path — one stat read per PID plus the /proc/stat totals — is a single C
call into ``kepler_tpu_torch.native`` instead of thousands of Python
open/read/parse round-trips. Everything cold (comm/exe/cgroup/environ/
cmdline, read once per PID at classification time) stays the Python
implementation.

``make_proc_reader`` picks the fast path when the native library is
available and falls back silently otherwise, so callers never care.
"""

from __future__ import annotations

import logging

import numpy as np

from kepler_tpu_torch import native
from kepler_tpu_torch.resource.procfs import ProcFSInfo, ProcFSReader

log = logging.getLogger("kepler.resource")


class FastProcInfo(ProcFSInfo):
    """ProcFSInfo whose cpu_time came from the batched native scan."""

    def __init__(self, procfs: str, pid: int, cpu_time_s: float) -> None:
        super().__init__(procfs, pid)
        self._cpu_time_s = cpu_time_s

    def cpu_time(self) -> float:
        return self._cpu_time_s


class FastProcFSReader(ProcFSReader):
    def __init__(self, scanner: native.NativeScanner,
                 procfs: str = "/proc") -> None:
        super().__init__(procfs)
        self._scanner = scanner

    def all_procs(self) -> list[FastProcInfo]:
        pids, cpu, _ = self._scanner.scan_procs(self._procfs,
                                                want_comms=False)
        return [
            FastProcInfo(self._procfs, int(p), float(c))
            for p, c in zip(pids, cpu)
        ]

    def scan_arrays(self) -> "tuple[np.ndarray, np.ndarray, np.ndarray]":
        """→ (pids int32, cpu_seconds f64, comms S32) numpy arrays — the
        allocation-free tick path: the informer updates its cache straight
        from these and only materializes a ProcInfo for NEW pids
        (classification). One C call, zero per-proc objects; comm comes
        from the stat line (the same field /proc/<pid>/comm serves), so no
        per-PID comm reads happen at all."""
        return self._scanner.scan_procs(self._procfs)

    def proc_info(self, pid: int) -> ProcFSInfo:
        """Cold-path reader for one PID (classification/comm/exe)."""
        return ProcFSInfo(self._procfs, pid)

    #: slot size for read_proc_files when the caller doesn't override it.
    #: Consumers that need truncation detection (informer
    #: _reread_if_truncated) read THIS attribute rather than duplicating
    #: the number — a content of exactly cap-1 bytes means ReadSmallFile
    #: hit the slot end.
    batch_read_cap: int = 16384

    def read_proc_files(self, relpaths: list[str],
                        per_cap: int | None = None) -> list[bytes | None]:
        """Batch-read ``<procfs>/<relpath>`` files in one threaded C call
        (first-sight classification bursts stay native)."""
        paths = [f"{self._procfs}/{rel}" for rel in relpaths]
        if per_cap is None:
            per_cap = self.batch_read_cap
        return self._scanner.read_files(paths, per_cap=per_cap)

    def read_proc_links(self, relpaths: list[str]) -> list[str | None]:
        """Batch-readlink ``<procfs>/<relpath>`` (e.g. ``<pid>/exe``)."""
        paths = [f"{self._procfs}/{rel}" for rel in relpaths]
        return self._scanner.read_links(paths)

    def _read_stat_totals(self) -> tuple[float, float]:
        return self._scanner.stat_totals(self._procfs)


def make_proc_reader(procfs: str = "/proc",
                     use_native: bool | None = None) -> ProcFSReader:
    """Best available reader: native batched scan if buildable, else Python.

    ``use_native``: True forces native (raises if unavailable), False forces
    Python, None (default) auto-detects.
    """
    if use_native is False:
        return ProcFSReader(procfs)
    scanner = native.scanner()
    if scanner is None:
        if use_native:
            import os
            why = ("disabled via KEPLER_NO_NATIVE"
                   if os.environ.get("KEPLER_NO_NATIVE")
                   else "no g++ or build failed")
            raise RuntimeError(
                f"native scanner requested but unavailable ({why})")
        return ProcFSReader(procfs)
    log.debug("using native procfs scanner (%s)", native.lib_path())
    return FastProcFSReader(scanner, procfs)
