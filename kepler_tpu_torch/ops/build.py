"""Build the port's CUDA kernels from ``ops/csrc`` and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with :mod:`ctypes`. The library lands in
``kepler_tpu_torch/_build/`` under a name that carries the hash of the
source and the flags, so an edited source rebuilds and an unchanged one
loads the library already built. Nothing here runs at import: the first
launch of a kernel builds it (``load``), and :func:`build_all` builds every
source up front, one ``nvcc`` per source, all started together.

Flags: ``sm_90a`` (Hopper), ``-O3``, and no ``--use_fast_math`` or
``-ftz=true`` — the kernels keep IEEE division, ``expf`` and denormals,
so B1 and B2 match their plain PyTorch versions bit for bit and B3 differs
from its plain version only in summation order.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names (stems) of every kernel source in ``csrc``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc_path() -> str:
    """The ``nvcc`` to build with: ``$CUDA_HOME/bin/nvcc``, else
    ``/usr/local/cuda/bin/nvcc``, else the one on ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a host with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to (content-addressed)."""
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for dep in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(dep.name.encode())
        h.update(dep.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[Path, Path, subprocess.Popen] | None:
    """Start nvcc on ``csrc/<name>.cu`` unless its library is built →
    (library, temporary output, process); nvcc's messages go to the
    temporary output's ``.log``."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    with open(tmp.with_suffix(".log"), "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    return out, tmp, proc


def _finish(name: str, started: tuple[Path, Path, subprocess.Popen]) -> Path:
    """Wait for a started nvcc → the library; raises with nvcc's output
    when it failed."""
    out, tmp, proc = started
    rc = proc.wait()
    log = tmp.with_suffix(".log")
    messages = log.read_text()
    log.unlink()
    if rc != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for {name}.cu (rc {rc}):\n{messages}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half
    return out


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    → the library's path. Raises with nvcc's output when it fails."""
    started = _start(name)
    return library_path(name) if started is None else _finish(name, started)


def build_all() -> dict[str, Path]:
    """Build every source in ``csrc``, one nvcc per source, all started
    together → name → library. Every nvcc has ended before a failure is
    raised."""
    started = {name: _start(name) for name in sources()}
    for job in started.values():
        if job is not None:
            job[2].wait()
    return {name: library_path(name) if job is None else _finish(name, job)
            for name, job in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _loaded[name] = lib
        return lib
