"""kepchaos event traces: canonical, hashable run transcripts.

Every conductor run appends typed events (spawn, send outcome, publish
digest, membership op, final counters) to a :class:`Trace`. The trace
serializes to *canonical JSON* (sorted keys, no whitespace, numpy
scalars coerced to Python) and hashes with SHA-256 — the determinism
pin asserts that replaying the same ``(seed, schedule)`` yields a
bit-identical canonical form, so ``trace_hash`` equality is the whole
test. Nothing wall-clock-derived may enter a trace event; all ``t``
fields are virtual-clock seconds.
"""

from __future__ import annotations

import hashlib
import json
import sys
from typing import Any


def jsonable(value: Any) -> Any:
    """Coerce numpy scalars/arrays, torch tensors (and nested
    containers) to plain Python so canonical JSON never depends on numpy
    or torch repr details."""
    torch = sys.modules.get("torch")   # a tensor implies torch is loaded
    if torch is not None and isinstance(value, torch.Tensor):
        return jsonable(value.tolist())   # 0-d -> number, n-d -> lists
    if isinstance(value, dict):
        return {str(k): jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [jsonable(v) for v in value]
    if isinstance(value, (str, int, bool)) or value is None:
        return value
    if isinstance(value, float):
        return value
    if hasattr(value, "item"):        # numpy scalar
        return jsonable(value.item())
    if hasattr(value, "tolist"):      # numpy array
        return jsonable(value.tolist())
    return str(value)


class Trace:
    """Append-only event transcript for one conductor run."""

    def __init__(self) -> None:
        self.events: list[dict[str, Any]] = []

    def emit(self, kind: str, **fields: Any) -> None:
        event = {"kind": kind}
        event.update(jsonable(fields))
        self.events.append(event)

    def canonical(self) -> str:
        return json.dumps(self.events, sort_keys=True,
                          separators=(",", ":"))

    def hash(self) -> str:
        return hashlib.sha256(self.canonical().encode()).hexdigest()

    def __len__(self) -> int:
        return len(self.events)


def digest_rows(rows: list[dict[str, Any]]) -> str:
    """Stable content digest for one published window's rows (used in
    ``publish`` trace events so traces stay small but still pin the
    numeric content bit-for-bit)."""
    canon = json.dumps(jsonable(rows), sort_keys=True,
                       separators=(",", ":"))
    return hashlib.sha256(canon.encode()).hexdigest()[:16]
