"""Fast Prometheus text exposition.

``prometheus_client.generate_latest`` spends >80% of a large scrape
re-validating and re-escaping every label NAME of every sample with
regexes (measured: 10k-process scrape ≈ 640 ms of ``sample_line``, of
which the attribution math is ~3%). Label names in a metric family are
static — validating them per-sample is pure waste on the node exporter's
hot path, where the reference's Go renderer is effectively free.

``fast_generate_latest`` renders byte-identical classic text format
(`text/plain; version=0.0.4`) for registries whose metric and label names
are legacy-valid (all kepler families are), validating each distinct
label-name tuple once per family instead of once per sample. Anything
non-legacy falls back to ``prometheus_client`` wholesale, so output is
ALWAYS exactly what the stock renderer would produce —
``tests/test_exporter_wire.py`` pins the byte equality.

Label VALUES still escape per sample (they are dynamic), with the same
replace chain as ``openmetrics._escape(ALLOWUTF8)``.
"""

from __future__ import annotations

import re
from math import copysign as _copysign

from prometheus_client.exposition import generate_latest
from prometheus_client.registry import Collector
from prometheus_client.utils import floatToGoString

_LEGACY_NAME = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LEGACY_LABEL = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
# OpenMetrics sample/family names: NO colons — the stock OM renderer
# escapes colons to underscores, so colon names must take the fallback
_OM_NAME = _LEGACY_LABEL

# OpenMetrics sample suffixes that the classic format renders as trailing
# gauges (mirrors generate_latest's om_samples munging)
_OM_SUFFIXES = ("_created", "_gsum", "_gcount")


def fmt_float(v: float) -> str:
    """floatToGoString with the overwhelmingly-common cases inlined (zeros
    and plain positive decimals); exponent-range, infinite, and negative
    values delegate to the real thing. Byte parity pinned in tests."""
    if v > 0.0:
        s = repr(v)
        dot = s.find(".")
        if 0 < dot <= 6:
            return s
        if dot == -1 and s[0] != "i":
            return s  # exponent repr like 1e-05: stock returns it verbatim
        return floatToGoString(v)  # inf, or ≥7 integer digits (Go-style e+)
    if v == 0.0:
        # copysign distinguishes -0.0; stock emits repr as-is
        return "0.0" if _copysign(1.0, v) > 0 else "-0.0"
    return floatToGoString(v)


def _escape_value(v: str) -> str:
    """openmetrics._escape(s, ALLOWUTF8, ...) replace chain, inlined."""
    if "\\" in v:
        v = v.replace("\\", "\\\\")
    if "\n" in v:
        v = v.replace("\n", "\\n")
    if '"' in v:
        v = v.replace('"', '\\"')
    return v


def _escape_doc(doc: str) -> str:
    return doc.replace("\\", "\\\\").replace("\n", "\\n")


def wants_openmetrics(request) -> bool:
    """Content negotiation shared by every /metrics handler: does the
    scraper's Accept header ask for the OpenMetrics exposition? (Default
    Prometheus does.)"""
    accept = ""
    if request is not None and getattr(request, "headers", None):
        accept = request.headers.get("Accept") or ""
    return "application/openmetrics-text" in accept


def fast_generate_openmetrics(registry: Collector) -> bytes:
    """Byte-identical ``openmetrics.exposition.generate_latest`` with
    per-family label-name validation (the OM twin of
    :func:`fast_generate_latest`). OM keeps each family's BASE name in
    HELP/TYPE (no classic ``_total``/``_info`` munging), renders sample
    lines identically, and terminates with ``# EOF``. Falls back to the
    stock renderer for anything beyond the simple counter/gauge/info
    families the kepler registries hold (exemplars, created timestamps,
    non-legacy names)."""
    from prometheus_client.openmetrics import exposition as om

    output: list[str] = []
    for metric in registry.collect():
        mname = metric.name
        if metric.type not in ("counter", "gauge", "info", "unknown"):
            return om.generate_latest(registry)  # histograms etc.: stock
        if not _OM_NAME.match(mname) or metric.unit:
            # colon names get underscore-escaped by the stock renderer;
            # units grow a suffix — both take the wholesale fallback
            return om.generate_latest(registry)
        # OM escapes quotes in HELP text too (classic does not); one
        # chain, same order as the stock renderer's _escape(ALLOWUTF8)
        doc = (metric.documentation.replace("\\", "\\\\")
               .replace("\n", "\\n").replace('"', '\\"'))
        output.append(f"# HELP {mname} {doc}\n")
        output.append(f"# TYPE {mname} {metric.type}\n")
        key_cache: tuple[str, ...] | None = None
        sorted_keys: list[str] = []
        for s in metric.samples:
            if (s.timestamp is not None or s.exemplar is not None
                    or not _OM_NAME.match(s.name)):
                return om.generate_latest(registry)
            if metric.type == "counter" and s.name.endswith("_created"):
                return om.generate_latest(registry)
            keys = tuple(s.labels)
            if keys != key_cache:
                if not all(_LEGACY_LABEL.match(k) for k in keys):
                    return om.generate_latest(registry)
                sorted_keys = sorted(keys)
                key_cache = keys
            labels = s.labels
            if labels:
                labelstr = "{%s}" % ",".join(
                    f'{k}="{_escape_value(labels[k])}"'
                    for k in sorted_keys)
            else:
                labelstr = ""
            output.append(
                f"{s.name}{labelstr} {floatToGoString(s.value)}\n")
    output.append("# EOF\n")
    return "".join(output).encode("utf-8")


def fast_generate_latest(registry: Collector) -> bytes:
    """Byte-identical ``generate_latest`` with per-family (not per-sample)
    label-name validation. Falls back to prometheus_client when any name
    is not legacy-valid."""
    output: list[str] = []
    for metric in registry.collect():
        mname = metric.name
        mtype = metric.type
        if mtype == "counter":
            mname += "_total"
        elif mtype == "info":
            mname += "_info"
            mtype = "gauge"
        elif mtype == "stateset":
            mtype = "gauge"
        elif mtype == "gaugehistogram":
            mtype = "histogram"
        elif mtype == "unknown":
            mtype = "untyped"
        if not _LEGACY_NAME.match(mname):
            return generate_latest(registry)  # rare: full fallback
        doc = _escape_doc(metric.documentation)
        output.append(f"# HELP {mname} {doc}\n")
        output.append(f"# TYPE {mname} {mtype}\n")

        key_cache: tuple[str, ...] | None = None
        sorted_keys: list[str] = []
        om_samples: dict[str, list[str]] = {}
        for s in metric.samples:
            if not _LEGACY_NAME.match(s.name):
                return generate_latest(registry)
            keys = tuple(s.labels)
            if keys != key_cache:
                if not all(_LEGACY_LABEL.match(k) for k in keys):
                    return generate_latest(registry)
                sorted_keys = sorted(keys)
                key_cache = keys
            labels = s.labels
            if labels:
                labelstr = "{%s}" % ",".join(
                    f'{k}="{_escape_value(labels[k])}"'
                    for k in sorted_keys)
            else:
                labelstr = ""
            ts = ""
            if s.timestamp is not None:
                ts = f" {int(float(s.timestamp) * 1000):d}"
            line = f"{s.name}{labelstr} {floatToGoString(s.value)}{ts}\n"
            for suffix in _OM_SUFFIXES:
                if s.name == metric.name + suffix:
                    om_samples.setdefault(suffix, []).append(line)
                    break
            else:
                output.append(line)
        for suffix, lines in sorted(om_samples.items()):
            output.append(f"# HELP {metric.name}{suffix} {doc}\n")
            output.append(f"# TYPE {metric.name}{suffix} gauge\n")
            output.extend(lines)
    return "".join(output).encode("utf-8")
