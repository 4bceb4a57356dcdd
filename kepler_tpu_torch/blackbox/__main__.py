"""``python -m kepler_tpu_torch.blackbox`` — reconstruct the fleet timeline.

Sources are positional and mixed freely:

- an incident bundle file (``/debug/bundle`` snapshot),
- a raw ``/debug/journal`` response or bare event-list JSON,
- a durable ``.kepj`` spool file,
- a live replica ``host:port`` (fetched over HTTP with cursor
  pagination; anything that is not an existing file is treated as an
  endpoint).

Output (``--format``): ``text`` (human timeline + findings), ``json``
(canonical — byte-deterministic, the ``--sha`` pin), or
``trace`` (Chrome trace events; load in Perfetto beside /debug/traces).
``--sha`` prints only the timeline SHA-256.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any

from kepler_tpu_torch.blackbox import (
    SCHEMA,
    analyze,
    chrome_trace,
    fetch_journal,
    load_source,
    merge_events,
    render_text,
    timeline_sha256,
)
from kepler_tpu_torch.fleet.journal import canonical_json


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m kepler_tpu_torch.blackbox", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("sources", nargs="+",
                        help="bundle/journal/.kepj files or live "
                             "host:port endpoints")
    parser.add_argument("--format", choices=("text", "json", "trace"),
                        default="text")
    parser.add_argument("--sha", action="store_true",
                        help="print only the merged-timeline SHA-256")
    parser.add_argument("--timeout", type=float, default=10.0,
                        help="HTTP timeout for live endpoints")
    args = parser.parse_args(argv)

    journals: list[list[dict[str, Any]]] = []
    for src in args.sources:
        try:
            if os.path.exists(src):
                journals.extend(load_source(src))
            else:
                journals.append(fetch_journal(src, timeout=args.timeout))
        except (OSError, ValueError) as err:
            print(f"error: {src}: {err}", file=sys.stderr)
            return 1
    merged = merge_events(journals)
    findings = analyze(merged)
    if args.sha:
        print(timeline_sha256(merged, findings))
        return 0
    if args.format == "text":
        sys.stdout.write(render_text(merged, findings))
    elif args.format == "json":
        sys.stdout.buffer.write(canonical_json(
            {"schema": SCHEMA, "events": merged,
             "findings": findings}))
        sys.stdout.write("\n")
    else:
        json.dump(chrome_trace(merged), sys.stdout)
        sys.stdout.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
