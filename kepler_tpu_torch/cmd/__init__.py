"""CLI entry points (reference ``cmd/``)."""

from __future__ import annotations

from typing import Sequence


def split_device(argv: Sequence[str]) -> tuple[str, list[str]]:
    """→ (the ``--device`` value, default ``cuda``; argv without it). The
    flag is the port's own (the node and aggregator binaries take it): it
    leaves argv before the config parser, a copy of the reference
    package's, sees it."""
    device, rest = "cuda", []
    it = iter(argv)
    for arg in it:
        if arg == "--device":
            device = next(it, "")
        elif arg.startswith("--device="):
            device = arg.split("=", 1)[1]
        else:
            rest.append(arg)
    if device not in ("cuda", "cpu"):
        raise ValueError(f"--device must be cuda or cpu, not {device!r}")
    return device, rest
