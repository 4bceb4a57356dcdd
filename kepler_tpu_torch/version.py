"""Build/version metadata.

Reference parity: ``internal/version/version.go:27`` exposes ldflags-injected
version/buildTime/branch/commit via ``version.Info()``. Here the same fields
are module attributes, optionally overridden at package-build time.
"""

from __future__ import annotations

import platform
from dataclasses import dataclass

__version__ = "0.1.0"

# Populated by the build (analog of Go ldflags -X injection, Makefile:45-49).
BUILD_TIME = "unknown"
GIT_BRANCH = "unknown"
GIT_COMMIT = "unknown"


@dataclass(frozen=True)
class VersionInfo:
    version: str
    build_time: str
    git_branch: str
    git_commit: str
    python_version: str
    platform: str


def info() -> VersionInfo:
    """Return structured version info (reference ``version.Info()``)."""
    return VersionInfo(
        version=__version__,
        build_time=BUILD_TIME,
        git_branch=GIT_BRANCH,
        git_commit=GIT_COMMIT,
        python_version=platform.python_version(),
        platform=f"{platform.system()}/{platform.machine()}",
    )
