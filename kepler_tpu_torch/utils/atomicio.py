"""Atomic small-file persistence shared by the durability plane.

The monitor's counter-state file and the spool's ack cursor both need
the same property: a reader (usually the next process incarnation) must
see either the previous complete document or the new complete document,
never a torn write. One implementation — write a sibling tmp file, then
``os.replace`` (atomic on POSIX within a filesystem) — keeps the
crash-safety semantics in a single place.
"""

from __future__ import annotations

import json
import os
from typing import Any


def atomic_write_json(path: str, obj: Any) -> None:
    """Write ``obj`` as JSON to ``path`` via tmp-file + atomic rename.

    Raises ``OSError`` on failure (callers decide whether a failed
    persist is fatal — for both current users it only weakens a
    redelivery/freshness guarantee, so they log and continue)."""
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(obj, fh)
    os.replace(tmp, path)
