"""Native (C++) fast path for host-side IO.

The attribution math runs on the device; what remains host-bound is
the per-tick procfs scan and sysfs counter reads. ``src/scan.cpp`` batches
those into single C calls; this module builds it on demand with ``g++``
(no pybind11 in the toolchain — plain C ABI via ctypes) and exposes a
typed wrapper.

The library lands in ``kepler_tpu_torch/_build/`` (beside the CUDA
kernels' libraries) under a name that carries the hash of the source and
the flags, as ``ops.build`` names them: an edited source rebuilds, an
unchanged one loads the library already built, and the name never
collides with the reference package's ``libkepler_scan.so`` in one
process.

Everything degrades gracefully: if no compiler or the build fails, callers
get ``None`` from :func:`load` and fall back to the pure-Python readers.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading

import numpy as np

log = logging.getLogger("kepler.native")

_SRC = os.path.join(os.path.dirname(__file__), "src", "scan.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          "_build")
_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread", "-Wall",
          "-Wextra")
_ABI_VERSION = 3

# comm slot width in kepler_scan_procs output (scan.cpp kCommSlot)
_COMM_SLOT = 32

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_load_failed = False


def lib_path() -> str:
    """Where ``src/scan.cpp`` builds to (content-addressed)."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SRC, "rb") as fh:
        h.update(fh.read())
    return os.path.join(_BUILD_DIR, f"libkt_scan_{h.hexdigest()[:16]}.so")


def ensure_built() -> str | None:
    """Compile the shared library unless it is built. Returns its path or
    None when the build fails (the compile is ~1 s, at most once per
    process)."""
    with _lock:
        lib = lib_path()
        if os.path.exists(lib):
            return lib
        os.makedirs(_BUILD_DIR, exist_ok=True)
        # compile to a pid-suffixed temp and rename: concurrent processes
        # (the in-process lock can't see them) each build privately and the
        # atomic rename means readers never dlopen a half-written .so
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = ["g++", *_FLAGS, _SRC, "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, lib)
        except (OSError, subprocess.SubprocessError) as err:
            detail = getattr(err, "stderr", b"") or b""
            log.warning("native build failed (%s): %s — using pure-Python "
                        "readers", err, detail.decode("utf-8", "replace")[:500])
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return None
        return lib


# keplint: role-boundary — one-time lazy build+dlopen, memoized in _lib;
# after the first call this is a pointer return, so hot-loop callers only
# ever pay the subprocess/compile cost once at startup
def load() -> ctypes.CDLL | None:
    """Load (building if needed) the native library; None on any failure."""
    global _lib, _load_failed
    if _lib is not None:
        return _lib
    if _load_failed or os.environ.get("KEPLER_NO_NATIVE"):
        return None
    path = ensure_built()
    if path is None:
        _load_failed = True
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.kepler_native_abi_version.restype = ctypes.c_int
        if lib.kepler_native_abi_version() != _ABI_VERSION:
            raise OSError(
                f"ABI mismatch: {lib.kepler_native_abi_version()} "
                f"!= {_ABI_VERSION}")
        lib.kepler_scan_procs.restype = ctypes.c_int
        lib.kepler_scan_procs.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_char),
            ctypes.c_int32,
        ]
        lib.kepler_scan_open.restype = ctypes.c_void_p
        lib.kepler_scan_open.argtypes = [ctypes.c_char_p, ctypes.c_int32]
        lib.kepler_scan_free.restype = None
        lib.kepler_scan_free.argtypes = [ctypes.c_void_p]
        lib.kepler_scan_tick.restype = ctypes.c_int
        lib.kepler_scan_tick.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_char),
            ctypes.c_int32,
        ]
        lib.kepler_read_stat_totals.restype = ctypes.c_int
        lib.kepler_read_stat_totals.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.kepler_read_counter_files.restype = ctypes.c_int
        lib.kepler_read_counter_files.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.kepler_read_files.restype = ctypes.c_int
        lib.kepler_read_files.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_char),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.kepler_read_links.restype = ctypes.c_int
        lib.kepler_read_links.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_char),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.kepler_fmt_double.restype = ctypes.c_int
        lib.kepler_fmt_double.argtypes = [
            ctypes.c_double,
            ctypes.POINTER(ctypes.c_char),
        ]
        lib.kepler_render_samples.restype = ctypes.c_int64
        lib.kepler_render_samples.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int32,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_double,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_char),
            ctypes.c_int64,
        ]
    except (OSError, AttributeError) as err:
        # AttributeError: a stale/foreign .so missing expected symbols
        log.warning("native load failed: %s — using pure-Python readers", err)
        _load_failed = True
        return None
    _lib = lib
    return lib


class NativeScanner:
    """Typed wrapper over the C calls. One instance is thread-safe.

    Scans go through a per-procfs *scan handle* (``kepler_scan_open``),
    which keeps each PID's stat fd open across ticks and preads it —
    ~5× faster than open/read/close per PID at 10k procs. One handle
    lives per distinct procfs path (a real agent has exactly one); a
    process-global fd budget in the C layer keeps many-handle test
    suites within RLIMIT_NOFILE. Handles are never auto-freed (freeing
    one under a concurrent scan would be use-after-free) — tests that
    churn thousands of fake trees can call :meth:`close_handles`.
    """

    def __init__(self, lib: ctypes.CDLL) -> None:
        self._lib = lib
        self._handles: dict[str, int] = {}  # procfs → C handle
        self._handles_lock = threading.Lock()

    def _handle(self, procfs: str) -> int | None:
        with self._handles_lock:
            h = self._handles.get(procfs)
            if h is not None:
                return h
            h = self._lib.kepler_scan_open(procfs.encode(), 0)
            if not h:
                return None
            self._handles[procfs] = h
            return h

    def close_handles(self) -> None:
        """Release every scan handle (and its cached fds)."""
        with self._handles_lock:
            for h in self._handles.values():
                self._lib.kepler_scan_free(h)
            self._handles.clear()

    def scan_procs(self, procfs: str = "/proc", cap: int = 8192,
                   want_comms: bool = True
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
        """→ (pids int32 [n], cpu_seconds f64 [n], comms S32 [n] | None)
        for all live PIDs. comms are the stat-line command names — the
        same field /proc/<pid>/comm serves, so callers skip per-PID comm
        reads entirely."""
        procfs_b = procfs.encode()
        handle = self._handle(procfs)
        while True:
            pids = np.empty(cap, np.int32)
            cpu = np.empty(cap, np.float64)
            comms = (np.zeros(cap, f"S{_COMM_SLOT}") if want_comms else None)
            comms_ptr = (comms.ctypes.data_as(ctypes.POINTER(ctypes.c_char))
                         if comms is not None else None)
            if handle is not None:
                n = self._lib.kepler_scan_tick(
                    handle,
                    pids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                    cpu.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                    comms_ptr, cap)
            else:
                n = self._lib.kepler_scan_procs(
                    procfs_b,
                    pids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                    cpu.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                    comms_ptr, cap)
            if n == -2:  # more PIDs than cap — grow and rescan
                cap *= 4
                continue
            if n < 0:
                raise OSError(f"cannot scan {procfs}")
            return (pids[:n].copy(), cpu[:n].copy(),
                    comms[:n].copy() if comms is not None else None)

    def stat_totals(self, procfs: str = "/proc") -> tuple[float, float]:
        """→ (active, total) jiffies from the aggregate 'cpu' line."""
        active = ctypes.c_double()
        total = ctypes.c_double()
        rc = self._lib.kepler_read_stat_totals(
            procfs.encode(), ctypes.byref(active), ctypes.byref(total))
        if rc != 0:
            raise OSError(f"cannot read {procfs}/stat")
        return active.value, total.value

    def read_counters(self, paths: list[str]) -> np.ndarray:
        """Batch-read uint64 counter files; failures → UINT64_MAX."""
        out = np.empty(len(paths), np.uint64)
        if not paths:
            return out
        blob = b"\0".join(p.encode() for p in paths) + b"\0"
        self._lib.kepler_read_counter_files(
            blob, len(paths),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
        return out

    def read_files(self, paths: list[str], per_cap: int = 8192
                   ) -> list[bytes | None]:
        """Batch-read small files (threaded in C); None per failed path.
        Contents truncate at ``per_cap - 1`` bytes — size accordingly."""
        n = len(paths)
        if n == 0:
            return []
        blob = b"\0".join(p.encode() for p in paths) + b"\0"
        out = np.empty(n * per_cap, np.uint8)
        sizes = np.empty(n, np.int32)
        rc = self._lib.kepler_read_files(
            blob, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_char)),
            per_cap,
            sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if rc < 0:
            raise OSError("batched file read failed")
        return [
            (out[i * per_cap:i * per_cap + sizes[i]].tobytes()
             if sizes[i] >= 0 else None)
            for i in range(n)
        ]

    def read_links(self, paths: list[str], per_cap: int = 1024
                   ) -> list[str | None]:
        """Batch-readlink (threaded in C); None per failed path."""
        n = len(paths)
        if n == 0:
            return []
        blob = b"\0".join(p.encode() for p in paths) + b"\0"
        out = np.empty(n * per_cap, np.uint8)
        sizes = np.empty(n, np.int32)
        rc = self._lib.kepler_read_links(
            blob, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_char)),
            per_cap,
            sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if rc < 0:
            raise OSError("batched readlink failed")
        return [
            (out[i * per_cap:i * per_cap + sizes[i]].tobytes()
             .decode("utf-8", "replace")) if sizes[i] >= 0 else None
            for i in range(n)
        ]

    def fmt_double(self, v: float) -> bytes:
        """floatToGoString-compatible formatting (parity-tested)."""
        buf = ctypes.create_string_buffer(48)
        n = self._lib.kepler_fmt_double(float(v), buf)
        return buf.raw[:n]

    def render_samples(self, name: bytes, prefix_blob: bytes,
                       prefix_off: np.ndarray, ztail_blob: bytes,
                       ztail_off: np.ndarray, values: np.ndarray,
                       div: float, round6: bool = False) -> bytes:
        """Render one metric family's sample lines (see scan.cpp).

        ``values`` must be C-contiguous float64 ``[n, nz]`` with
        ``n == len(prefix_off) - 1`` and ``nz == len(ztail_off) - 1``;
        ``prefix_off``/``ztail_off`` are int64/int32 byte offsets into the
        blobs. Returns the rendered classic-text bytes.
        """
        n = len(prefix_off) - 1
        nz = len(ztail_off) - 1
        values = np.ascontiguousarray(values, np.float64)
        if values.shape != (n, nz):
            raise ValueError(f"values shape {values.shape} != ({n}, {nz})")
        # worst case per sample: name + prefix + ztail + 48-char float + \n.
        # np.empty = malloc without memset (create_string_buffer would
        # zero-fill megabytes per scrape for nothing)
        cap = (nz * len(prefix_blob) + n * len(ztail_blob)
               + n * nz * (len(name) + 49) + 64)
        out = np.empty(cap, np.uint8)
        rc = self._lib.kepler_render_samples(
            name, len(name), prefix_blob,
            prefix_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n, ztail_blob,
            ztail_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            nz,
            values.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            float(div), 1 if round6 else 0,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_char)), cap)
        if rc < 0:
            raise OSError("native sample render failed (buffer overflow?)")
        return out[:rc].tobytes()


def scanner() -> NativeScanner | None:
    """The process-wide scanner, or None when native is unavailable."""
    lib = load()
    return NativeScanner(lib) if lib is not None else None
