"""Fleet black-box reader: merge per-replica journals into one timeline.

The counterpart of ``kepler_tpu.blackbox``, over the port's journal.

The fleet's incident story is scattered across N replicas' event
journals (``/debug/journal``), incident bundles (``/debug/bundle``) and
durable ``.kepj`` spool files. This package loads any mix of those
sources, merges the events into one causally-ordered fleet timeline
(HLC order: ``(phys_us, logical, node)``), and flags the two classic
fleet pathologies on the way out:

- **split-brain** — two nodes adopting a coordinator lease for the same
  epoch with different holders, or two membership applies at one epoch
  disagreeing on the peer set;
- **flapping** — a breaker or rung oscillating (≥ ``_FLAP_N``
  transitions on one node inside ``_FLAP_WINDOW_S``).

Everything here is deterministic: same inputs → byte-identical merged
timeline → same SHA-256 (``tests/test_torch_blackbox.py`` pins it
against the reference reader). No wall-clock reads, no set iteration
without sorting.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Iterable

from kepler_tpu_torch.fleet.journal import canonical_json, read_frames

__all__ = [
    "analyze",
    "chrome_trace",
    "fetch_journal",
    "load_source",
    "merge_events",
    "render_text",
    "timeline_sha256",
]

SCHEMA = "kepler-blackbox/v1"
_FLAP_N = 4
_FLAP_WINDOW_S = 120.0


def _hlc_key(entry: dict[str, Any]) -> tuple[int, int, str]:
    h = entry.get("hlc") or {}
    return (int(h.get("phys_us", 0)), int(h.get("logical", 0)),
            str(h.get("node", "")))


def merge_events(journals: Iterable[list[dict[str, Any]]]
                 ) -> list[dict[str, Any]]:
    """Merge journal dumps into one HLC-ordered timeline, dropping
    exact duplicates (one node's journal seen via two sources)."""
    seen: set[tuple[int, int, str, str]] = set()
    merged: list[dict[str, Any]] = []
    for journal in journals:
        for entry in journal:
            if not isinstance(entry, dict) or "hlc" not in entry:
                continue
            key = _hlc_key(entry) + (str(entry.get("kind", "")),)
            if key in seen:
                continue
            seen.add(key)
            merged.append(entry)
    merged.sort(key=_hlc_key)
    return merged


def load_source(path: str) -> list[list[dict[str, Any]]]:
    """One on-disk source → journal dumps. Accepts a ``/debug/bundle``
    snapshot, a raw ``/debug/journal`` response, a bare event list, or
    a durable ``.kepj`` frame file."""
    if path.endswith(".kepj"):
        return [read_frames(path)]
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if isinstance(doc, list):
        return [doc]
    if isinstance(doc, dict):
        if isinstance(doc.get("journal"), list):        # bundle
            return [doc["journal"]]
        if isinstance(doc.get("events"), list):         # /debug/journal
            return [doc["events"]]
    raise ValueError(f"{path}: not a bundle, journal dump, or .kepj file")


def fetch_journal(endpoint: str, timeout: float = 10.0,
                  page: int = 512) -> list[dict[str, Any]]:
    """Drain a live replica's ``/debug/journal`` via cursor pagination.
    ``endpoint`` is ``host:port`` (or a full ``http://`` URL prefix)."""
    import urllib.request

    base = (endpoint if endpoint.startswith("http")
            else f"http://{endpoint}")
    events: list[dict[str, Any]] = []
    cursor = ""
    while True:
        url = f"{base}/debug/journal?limit={page}"
        if cursor:
            url += f"&since={cursor}"
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            doc = json.load(resp)
        batch = doc.get("events", [])
        events.extend(batch)
        cursor = doc.get("cursor", "")
        if not batch or not cursor:
            return events


# -- findings ---------------------------------------------------------------


def analyze(merged: list[dict[str, Any]]) -> list[dict[str, Any]]:
    """Deterministic pathology scan over the merged timeline."""
    findings: list[dict[str, Any]] = []
    # split-brain: same epoch, conflicting lease holders
    holders: dict[int, dict[str, str]] = {}
    peer_sets: dict[int, dict[str, str]] = {}
    for entry in merged:
        kind = entry.get("kind", "")
        fields = entry.get("fields", {}) or {}
        node = str((entry.get("hlc") or {}).get("node", ""))
        if kind == "lease.adopt" and "epoch" in fields:
            holders.setdefault(int(fields["epoch"]), {})[node] = str(
                fields.get("holder", ""))
        elif kind == "membership.apply" and "epoch" in fields:
            peers = ",".join(sorted(fields.get("peers", []) or []))
            peer_sets.setdefault(int(fields["epoch"]), {})[node] = peers
    for epoch in sorted(holders):
        views = holders[epoch]
        if len(set(views.values())) > 1:
            findings.append({
                "finding": "split_brain_lease", "epoch": epoch,
                "holders": {n: views[n] for n in sorted(views)}})
    for epoch in sorted(peer_sets):
        views = peer_sets[epoch]
        if len(set(views.values())) > 1:
            findings.append({
                "finding": "split_brain_membership", "epoch": epoch,
                "views": {n: views[n] for n in sorted(views)}})
    # flapping: breaker / rung oscillation per node inside the window
    for family, kinds in (("breaker", ("breaker.open", "breaker.close")),
                          ("rung", ("rung.transition",))):
        per_node: dict[str, list[int]] = {}
        for entry in merged:
            if entry.get("kind") in kinds:
                node = str((entry.get("hlc") or {}).get("node", ""))
                per_node.setdefault(node, []).append(
                    int(entry["hlc"]["phys_us"]))
        for node in sorted(per_node):
            stamps = per_node[node]
            window_us = int(_FLAP_WINDOW_S * 1e6)
            for i in range(len(stamps) - _FLAP_N + 1):
                if stamps[i + _FLAP_N - 1] - stamps[i] <= window_us:
                    findings.append({
                        "finding": f"{family}_flap", "node": node,
                        "transitions": _FLAP_N,
                        "window_s": _FLAP_WINDOW_S})
                    break
    return findings


# -- renders ----------------------------------------------------------------


def render_text(merged: list[dict[str, Any]],
                findings: list[dict[str, Any]]) -> str:
    lines: list[str] = []
    base_us = merged[0]["hlc"]["phys_us"] if merged else 0
    for entry in merged:
        h = entry["hlc"]
        rel = (h["phys_us"] - base_us) / 1e6
        kv = " ".join(f"{k}={entry['fields'][k]}"
                      for k in sorted(entry.get("fields", {})))
        lines.append(f"+{rel:10.3f}s .{h['logical']:<3d} "
                     f"[{h['node']}] {entry['kind']} {kv}".rstrip())
    lines.append(f"-- {len(merged)} events, {len(findings)} findings")
    for f in findings:
        kv = " ".join(f"{k}={f[k]}" for k in sorted(f)
                      if k != "finding")
        lines.append(f"!! {f['finding']} {kv}".rstrip())
    return "\n".join(lines) + "\n"


def chrome_trace(merged: list[dict[str, Any]]) -> dict[str, Any]:
    """Chrome trace-event render: instant events on the HLC physical-µs
    axis, one track per node — loads in Perfetto beside /debug/traces'
    span export (both use wall-clock µs timestamps)."""
    nodes = sorted({str(e["hlc"]["node"]) for e in merged})
    pid_of = {n: i + 1 for i, n in enumerate(nodes)}
    events: list[dict[str, Any]] = []
    for node in nodes:
        events.append({"name": "process_name", "ph": "M",
                       "pid": pid_of[node], "tid": 0,
                       "args": {"name": node or "(unnamed)"}})
    for entry in merged:
        h = entry["hlc"]
        events.append({
            "name": entry["kind"], "ph": "i", "s": "p",
            "cat": "kepler-blackbox", "ts": h["phys_us"],
            "pid": pid_of[str(h["node"])], "tid": 0,
            "args": dict(entry.get("fields", {}))})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def timeline_sha256(merged: list[dict[str, Any]],
                    findings: list[dict[str, Any]]) -> str:
    return hashlib.sha256(canonical_json(
        {"schema": SCHEMA, "events": merged,
         "findings": findings})).hexdigest()
