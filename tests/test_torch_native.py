"""The port's native scanner under ThreadSanitizer.

``kepler_tpu_torch/native/src/scan_tsan_test.cpp`` (a copy of the
reference's harness) is built with ``scan.cpp`` and ``-fsanitize=thread``
and hammers every exported call from 8 threads over a fake /proc tree, as
``tests/test_native.py`` does for the reference's copy. Skips where the
toolchain lacks libtsan.
"""

from __future__ import annotations

import os
import subprocess

import pytest

from kepler_tpu_torch import native

SRC = os.path.join(os.path.dirname(native.__file__), "src")


def test_tsan_harness_clean(tmp_path):
    binary = tmp_path / "scan_tsan"
    build = subprocess.run(
        ["g++", "-O1", "-g", "-fsanitize=thread", "-std=c++17",
         os.path.join(SRC, "scan.cpp"),
         os.path.join(SRC, "scan_tsan_test.cpp"), "-o", str(binary)],
        capture_output=True, timeout=120)
    if build.returncode != 0:
        pytest.skip(f"no TSAN toolchain: {build.stderr.decode()[:200]}")
    run = subprocess.run([str(binary)], capture_output=True, timeout=300)
    assert run.returncode == 0, (run.stdout.decode()
                                 + run.stderr.decode())[:2000]
    assert b"clean" in run.stdout


def test_harness_calls_only_what_the_port_scanner_exports():
    """Every function the harness declares is an ``extern "C"`` export
    of the port's scan.cpp (the link above would fail otherwise, but the
    skip hides that where libtsan is missing)."""
    import re

    def names(path: str, pattern: str) -> set[str]:
        return set(re.findall(pattern, open(path).read(), re.MULTILINE))

    exported = names(os.path.join(SRC, "scan.cpp"),
                     r"^(?:int|int64_t|void\*?)\s+(kepler_\w+)\(")
    declared = names(os.path.join(SRC, "scan_tsan_test.cpp"),
                     r"^(?:int|int64_t|void\*?)\s+(kepler_\w+)\(")
    assert declared and declared <= exported, declared - exported
