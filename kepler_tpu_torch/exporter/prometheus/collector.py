"""Prometheus power collector.

Reference parity: ``internal/exporter/prometheus/collector/power_collector.go``
— one ``collect()`` takes exactly one ``Snapshot()`` so all series in a scrape
are consistent (:215); metric families/labels match ``docs/user/metrics.md``;
a readiness gate waits for the monitor's first refresh (:142-152); the
metrics-level bitmask selects which families are emitted.

Metric families (names/labels identical to the reference):
  kepler_node_cpu_joules_total{zone,path}                + active/idle variants
  kepler_node_cpu_watts{zone,path}                       + active/idle variants
  kepler_node_cpu_usage_ratio
  kepler_process_cpu_joules_total{pid,comm,exe,type,state,container_id,vm_id,zone}
  kepler_process_cpu_watts{...}, kepler_process_cpu_seconds_total{...}
  kepler_container_cpu_joules_total{container_id,container_name,runtime,state,zone,pod_id}
  kepler_vm_cpu_joules_total{vm_id,vm_name,hypervisor,state,zone}
  kepler_pod_cpu_joules_total{pod_id,pod_name,pod_namespace,state,zone}
"""

from __future__ import annotations

import logging
from typing import Iterable

from prometheus_client.core import CounterMetricFamily, GaugeMetricFamily

from kepler_tpu_torch.config.level import Level
from kepler_tpu_torch.device.energy import JOULE, WATT
from kepler_tpu_torch.monitor.monitor import (PowerMonitor,
                                        SnapshotUnavailableError)
from kepler_tpu_torch.monitor.snapshot import WorkloadTable

log = logging.getLogger("kepler.exporter.prometheus")

_META_LABEL_SETS = {
    "process": ("pid", "comm", "exe", "type", "container_id", "vm_id"),
    "container": ("container_id", "container_name", "runtime", "pod_id"),
    "vm": ("vm_id", "vm_name", "hypervisor"),
    "pod": ("pod_id", "pod_name", "pod_namespace"),
}

# ONE definition of the family tables, consumed by both the registry path
# (collect()) and the direct text fast path (render_text()) — keep them
# here so the two renders cannot diverge.
#   kind → (level bit, Snapshot attr, terminated Snapshot attr)
_KIND_TABLES = (
    ("process", Level.PROCESS, "processes", "terminated_processes"),
    ("container", Level.CONTAINER, "containers", "terminated_containers"),
    ("vm", Level.VM, "virtual_machines", "terminated_virtual_machines"),
    ("pod", Level.POD, "pods", "terminated_pods"),
)
#   (name suffix, type, doc stem, NodeUsage attrs (total, active, idle),
#    unit scale)
_NODE_VARIANTS = (
    ("joules_total", "counter", "Energy consumption of cpu",
     ("energy_uj", "active_uj", "idle_uj"), 1 / JOULE),
    ("watts", "gauge", "Power consumption of cpu",
     ("power_uw", "active_power_uw", "idle_power_uw"), 1 / WATT),
)


def _node_family_doc(desc: str, state: str) -> str:
    return (f"{desc}"
            f"{' in ' + state.rstrip('_') + ' state' if state else ''}"
            " at node level")


_NATIVE_RENDERER = False  # False = unresolved; None = unavailable


def _native_renderer():
    """Process-wide native sample renderer, or None (pure-Python render)."""
    global _NATIVE_RENDERER
    if _NATIVE_RENDERER is False:
        try:
            from kepler_tpu_torch import native
            _NATIVE_RENDERER = native.scanner()
        except Exception:  # no compiler / load failure → Python fallback
            _NATIVE_RENDERER = None
    return _NATIVE_RENDERER


class PowerCollector:
    """Custom collector; registered into the exporter's registry."""

    def __init__(
        self,
        monitor: PowerMonitor,
        node_name: str = "",
        metrics_level: Level = Level.all(),
        ready_timeout: float = 0.0,
    ) -> None:
        self._monitor = monitor
        self._node_name = node_name
        self._level = metrics_level
        self._ready_timeout = ready_timeout
        # render_text()'s cached per-row label block holds every label
        # EXCEPT zone and is reused verbatim with `,zone="…"` appended —
        # sound only while every other label name sorts before "zone".
        # Enforce here (not via assert: -O must not silently change series
        # identity) so a future label addition fails loudly at construction.
        const_keys = ["node_name"] if node_name else []
        for kind, names in _META_LABEL_SETS.items():
            bad = [k for k in [*names, "state", *const_keys] if k >= "zone"]
            if bad:
                raise ValueError(
                    f"label names {bad} for kind {kind!r} sort at/after "
                    "'zone'; the cached-prefix text render requires all "
                    "non-zone labels to sort before it")

    def _is_ready(self) -> bool:
        return self._monitor.data_channel().wait(self._ready_timeout)

    def collect(self):
        if not self._is_ready():
            log.debug("collector not ready: no snapshot yet")
            return
        try:
            snap = self._monitor.snapshot()  # ONE snapshot per scrape
        except SnapshotUnavailableError as err:
            # defined degradation: an empty scrape (plus a warning) beats a
            # 500 with a traceback — Prometheus records the target up with
            # no kepler families, and the next scrape retries the refresh
            log.warning("scrape skipped: %s", err)
            return
        const = {"node_name": self._node_name} if self._node_name else {}

        if Level.NODE in self._level:
            yield from self._node_metrics(snap, const)
            ratio = GaugeMetricFamily(
                "kepler_node_cpu_usage_ratio",
                "CPU usage ratio of a node (active/total)",
                labels=list(const))
            yield self._with_const(ratio, [], snap.node.usage_ratio, const)
        zone_names = snap.node.zone_names
        for kind, level, run_attr, term_attr in _KIND_TABLES:
            if level not in self._level:
                continue
            yield from self._workload_metrics(
                kind, zone_names, getattr(snap, run_attr),
                getattr(snap, term_attr), const)

    # -- helpers ----------------------------------------------------------

    @staticmethod
    def _with_const(family, labels: list[str], value: float,
                    const: dict[str, str]):
        family.add_metric(labels + list(const.values()), value)
        return family

    def _node_metrics(self, snap, const: dict[str, str]):
        node = snap.node
        const_keys = list(const)
        for suffix, mtype, desc, attrs, scale in _NODE_VARIANTS:
            ctor = (CounterMetricFamily if mtype == "counter"
                    else GaugeMetricFamily)
            for state, attr in zip(("", "active_", "idle_"), attrs):
                values = getattr(node, attr)
                name = f"kepler_node_cpu_{state}{suffix}"
                family = ctor(
                    name, _node_family_doc(desc, state),
                    labels=["zone", "path"] + const_keys)
                for z, zone in enumerate(node.zone_names):
                    family.add_metric(
                        [zone, ""] + list(const.values()),
                        float(values[z]) * scale)
                yield family

    def _workload_metrics(self, kind: str, zone_names,
                          running: WorkloadTable, terminated: WorkloadTable,
                          const: dict[str, str]):
        label_names = list(_META_LABEL_SETS[kind])
        full_labels = label_names + ["state", "zone"] + list(const)
        joules = CounterMetricFamily(
            f"kepler_{kind}_cpu_joules_total",
            f"Energy consumption of cpu at {kind} level in joules",
            labels=full_labels)
        watts = GaugeMetricFamily(
            f"kepler_{kind}_cpu_watts",
            f"Power consumption of cpu at {kind} level in watts",
            labels=full_labels)
        seconds = None
        if kind == "process":
            seconds = CounterMetricFamily(
                "kepler_process_cpu_seconds_total",
                "Total user and system time of the process in seconds",
                labels=label_names + ["state"] + list(const))
        for state, table in (("running", running), ("terminated", terminated)):
            for i, wid in enumerate(table.ids):
                meta = table.meta[i]
                values = self._label_values(kind, wid, meta, label_names)
                for z, zone in enumerate(zone_names):
                    lv = values + [state, zone] + list(const.values())
                    joules.add_metric(lv, float(table.energy_uj[i, z]) / JOULE)
                    watts.add_metric(lv, float(table.power_uw[i, z]) / WATT)
                if seconds is not None and table.seconds is not None:
                    # 6-decimal rounding matches the reference's seconds
                    # formatting (and the native renderer's round6 flag)
                    seconds.add_metric(
                        values + [state] + list(const.values()),
                        float(f"{float(table.seconds[i]):.6f}"))
        yield joules
        yield watts
        if seconds is not None:
            yield seconds

    # -- direct text render (the node hot path) ---------------------------
    #
    # Rendering 10k processes through prometheus_client costs ~650 ms per
    # scrape (per-sample Metric objects + per-sample label re-escaping);
    # the snapshot already holds everything in table form, so the exporter
    # renders the kepler families straight to classic text, caching each
    # workload's escaped label block across scrapes (labels change on
    # exec/reclassify; counters change every tick). Output is byte-
    # identical to prometheus_client's generate_latest over this collector
    # — pinned by tests/test_exporter_wire.py.

    def render_text(self, openmetrics: bool = False) -> bytes:
        """Text exposition of this collector's families (fast path).
        Empty bytes when not ready / snapshot unavailable — the same
        scrapes collect() would skip.

        Per-row label blocks are cached as bytes across scrapes (labels
        change on exec/reclassify; values change every tick); when the
        native library is present the value formatting and line assembly
        for a whole family happen in ONE C call
        (``kepler_render_samples``), so a 10k-process scrape does no
        per-sample Python work at all. Byte parity with the stock
        renderer is pinned by tests/test_exporter_wire.py either way.

        ``openmetrics=True`` emits the OpenMetrics exposition instead —
        sample lines are byte-identical to classic text for these
        families; only the counter HELP/TYPE header names differ (base
        name instead of ``*_total``). Modern Prometheus negotiates
        OpenMetrics BY DEFAULT, so this path is just as hot as classic.
        The caller appends the ``# EOF`` terminator (the exporter
        concatenates several renders first).
        """
        from kepler_tpu_torch.exporter.prometheus.fastexpo import _escape_value

        if not self._is_ready():
            return b""
        try:
            # no deep clone: the render only reads, and published
            # snapshots are immutable (see PowerMonitor.snapshot)
            snap = self._monitor.snapshot(clone=False)
        except SnapshotUnavailableError as err:
            log.warning("scrape skipped: %s", err)
            return b""
        const = {"node_name": self._node_name} if self._node_name else {}
        out: list[bytes] = []
        if Level.NODE in self._level:
            node_out: list[str] = []
            self._render_node_text(node_out, snap, const, openmetrics)
            out.append("".join(node_out).encode("utf-8"))
        ezones = [(z, _escape_value(z)) for z in snap.node.zone_names]
        new_cache: dict = {}
        for kind, level, run_attr, term_attr in _KIND_TABLES:
            if level not in self._level:
                continue
            self._render_workload_text(out, kind, ezones,
                                       getattr(snap, run_attr),
                                       getattr(snap, term_attr), const,
                                       new_cache, openmetrics)
        self._label_cache = new_cache  # drop vanished workloads' entries
        return b"".join(out)

    @staticmethod
    def _header_name(sample_name: str, openmetrics: bool) -> str:
        """OpenMetrics HELP/TYPE lines carry the FAMILY name (no _total);
        classic text carries the suffixed sample name."""
        if openmetrics and sample_name.endswith("_total"):
            return sample_name[:-len("_total")]
        return sample_name

    def _render_node_text(self, out: list[str], snap, const,
                          openmetrics: bool = False) -> None:
        from prometheus_client.utils import floatToGoString

        from kepler_tpu_torch.exporter.prometheus.fastexpo import _escape_value

        node = snap.node
        for suffix, mtype, desc, attrs, scale in _NODE_VARIANTS:
            for state, attr in zip(("", "active_", "idle_"), attrs):
                values = getattr(node, attr)
                name = f"kepler_node_cpu_{state}{suffix}"
                doc = _node_family_doc(desc, state)
                hname = self._header_name(name, openmetrics)
                out.append(f"# HELP {hname} {doc}\n")
                out.append(f"# TYPE {hname} {mtype}\n")
                for z, zone in enumerate(node.zone_names):
                    pairs = sorted({"zone": zone, "path": "",
                                    **const}.items())
                    labelstr = ",".join(
                        f'{k}="{_escape_value(v)}"' for k, v in pairs)
                    out.append(f"{name}{{{labelstr}}} "
                               f"{floatToGoString(values[z] * scale)}\n")
        name = "kepler_node_cpu_usage_ratio"
        out.append(f"# HELP {name} CPU usage ratio of a node "
                   "(active/total)\n")
        out.append(f"# TYPE {name} gauge\n")
        if const:
            pairs = sorted(const.items())
            labelstr = "{%s}" % ",".join(
                f'{k}="{_escape_value(v)}"' for k, v in pairs)
        else:
            labelstr = ""
        out.append(f"{name}{labelstr} "
                   f"{floatToGoString(node.usage_ratio)}\n")

    def _render_workload_text(self, out: list[bytes], kind: str, ezones,
                              running: WorkloadTable,
                              terminated: WorkloadTable, const,
                              new_cache: dict,
                              openmetrics: bool = False) -> None:
        from kepler_tpu_torch.exporter.prometheus.fastexpo import (_escape_value,
                                                            fmt_float)

        label_names = list(_META_LABEL_SETS[kind])
        # the cached per-row block holds every label EXCEPT zone; sound
        # because every other label name sorts before "zone" — enforced
        # with a real ValueError in __init__
        nonzone = label_names + ["state"] + list(const)
        order = sorted(range(len(nonzone)), key=lambda i: nonzone[i])
        jname = f"kepler_{kind}_cpu_joules_total"
        wname = f"kepler_{kind}_cpu_watts"
        cache = getattr(self, "_label_cache", {})
        const_vals = tuple(const.values())
        is_process = kind == "process"
        states = (("running", running), ("terminated", terminated))
        # pass 1: per-row label blocks. The whole (prefix list, joined
        # blob, offsets) is cached per state keyed on the table's id and
        # meta tuples — meta dicts are object-cached by the informer, so
        # in the steady state (values change, labels don't) this is two
        # tuple comparisons, not 10k dict probes.
        prefixes_by_state: list[tuple[list[bytes], bytes, object]] = []
        blob_cache = getattr(self, "_blob_cache", {})
        new_blobs = {}
        for state, table in states:
            bkey = (kind, state)
            blob_cached = blob_cache.get(bkey)
            if (blob_cached is not None and blob_cached[0] == table.ids
                    and blob_cached[1] == table.meta):
                new_blobs[bkey] = blob_cached
                prefixes_by_state.append(blob_cached[2])
                # keep the per-row cache warm for the next membership
                # change (one C-level bulk copy, no per-row Python)
                new_cache.update(blob_cached[3])
                continue
            metas = table.meta
            prefixes: list[bytes] = []
            row_cache: dict = {}
            for i, wid in enumerate(table.ids):
                meta = metas[i]
                key = (kind, state, wid)
                cached = cache.get(key)
                if cached is not None and (cached[0] is meta
                                           or cached[0] == meta):
                    prefix = cached[1]
                    new_cache[key] = cached
                else:
                    values = self._label_values(kind, wid, meta,
                                                label_names)
                    row = tuple(values) + (state,) + const_vals
                    prefix = ("{" + ",".join(
                        f'{nonzone[i_]}="{_escape_value(row[i_])}"'
                        for i_ in order)).encode("utf-8")
                    cached = (meta, prefix)
                    new_cache[key] = cached
                row_cache[key] = cached
                prefixes.append(prefix)
            import numpy as np
            off = np.zeros(len(prefixes) + 1, np.int64)
            if prefixes:
                np.cumsum([len(p) for p in prefixes], out=off[1:])
            entry3 = (prefixes, b"".join(prefixes), off)
            new_blobs[bkey] = (table.ids, table.meta, entry3, row_cache)
            prefixes_by_state.append(entry3)
        blob_cache.update(new_blobs)
        self._blob_cache = blob_cache
        ztails = [f',zone="{ez}"}} '.encode("utf-8") for _, ez in ezones]
        native = _native_renderer()
        # pass 2: families — joules, watts, then (processes) seconds; each
        # family lists running rows then terminated rows, matching the
        # registry renderer's sample order
        jhead = self._header_name(jname, openmetrics)
        out.append(f"# HELP {jhead} Energy consumption of cpu at {kind} "
                   f"level in joules\n# TYPE {jhead} counter\n".encode())
        self._render_family(out, jname.encode(), prefixes_by_state, states,
                            "energy_uj", ztails, JOULE, native, fmt_float)
        out.append(f"# HELP {wname} Power consumption of cpu at {kind} "
                   f"level in watts\n# TYPE {wname} gauge\n".encode())
        self._render_family(out, wname.encode(), prefixes_by_state, states,
                            "power_uw", ztails, WATT, native, fmt_float)
        if is_process:
            shead = self._header_name("kepler_process_cpu_seconds_total",
                                      openmetrics)
            out.append(f"# HELP {shead} Total user and system time of "
                       f"the process in seconds\n"
                       f"# TYPE {shead} counter\n".encode())
            self._render_family(out, b"kepler_process_cpu_seconds_total",
                                prefixes_by_state, states, "seconds",
                                [b"} "], 1.0, native, fmt_float,
                                round6=True)

    @staticmethod
    def _render_family(out: list[bytes], name: bytes,
                       prefixes_by_state, states, attr: str,
                       ztails: list[bytes], div: float, native,
                       fmt_float, round6: bool = False) -> None:
        """One family's sample lines (running then terminated rows):
        native renderer when available, else a per-sample Python loop
        producing identical bytes."""
        import numpy as np
        for (prefixes, blob, off), (_state, table) in zip(
                prefixes_by_state, states):
            values = getattr(table, attr)
            if values is None or not len(prefixes):
                continue
            if values.ndim == 1:
                values = values[:, None]
            if native is not None:
                zoff = np.zeros(len(ztails) + 1, np.int32)
                np.cumsum([len(z) for z in ztails], out=zoff[1:])
                out.append(native.render_samples(
                    name, blob, off, b"".join(ztails), zoff,
                    values, div, round6=round6))
                continue
            for i, prefix in enumerate(prefixes):
                for z, ztail in enumerate(ztails):
                    v = float(values[i, z]) / div
                    if round6:
                        v = float(f"{v:.6f}")
                    out.append(name + prefix + ztail
                               + fmt_float(v).encode() + b"\n")

    @staticmethod
    def _label_values(kind: str, wid: str, meta, label_names: Iterable[str]
                      ) -> list[str]:
        id_label = {"process": "pid", "container": "container_id",
                    "vm": "vm_id", "pod": "pod_id"}[kind]
        alias = {"pod_name": "pod_name", "pod_namespace": "namespace",
                 "vm_name": "vm_name"}
        out = []
        for name in label_names:
            if name == id_label:
                out.append(wid)
            elif name in meta:
                out.append(str(meta[name]))
            elif name in alias and alias[name] in meta:
                out.append(str(meta[alias[name]]))
            else:
                out.append("")
        return out
