"""Prometheus exporter service.

Reference parity: ``internal/exporter/prometheus/prometheus.go`` — owns its
own registry (no global default-registry pollution), optional debug
collectors ("go" → Python runtime collectors here), registers ``/metrics``
on the shared API server with OpenMetrics-capable exposition.
"""

from __future__ import annotations

import logging
from typing import Sequence

from prometheus_client import CollectorRegistry
from prometheus_client.exposition import CONTENT_TYPE_LATEST

from kepler_tpu_torch import telemetry
from kepler_tpu_torch.config.level import Level
from kepler_tpu_torch.exporter.prometheus.fastexpo import fast_generate_latest
from kepler_tpu_torch.exporter.prometheus.collector import PowerCollector
from kepler_tpu_torch.exporter.prometheus.info_collectors import (
    BuildInfoCollector,
    CPUInfoCollector,
)
from kepler_tpu_torch.monitor.monitor import PowerMonitor
from kepler_tpu_torch.server.http import APIServer

log = logging.getLogger("kepler.exporter.prometheus")


def create_collectors(
    monitor: PowerMonitor,
    node_name: str = "",
    metrics_level: Level = Level.all(),
    procfs: str = "/proc",
    ready_timeout: float = 0.0,
    meter_source: str = "",
) -> list:
    """Standard collector set (reference CreateCollectors :139-158)."""
    collectors = [
        PowerCollector(monitor, node_name=node_name,
                       metrics_level=metrics_level,
                       ready_timeout=ready_timeout),
        BuildInfoCollector(),
        CPUInfoCollector(procfs=procfs),
    ]
    if meter_source:
        from kepler_tpu_torch.exporter.prometheus.info_collectors import (
            PowerMeterInfoCollector,
        )

        collectors.append(PowerMeterInfoCollector(meter_source))
    return collectors


class PrometheusExporter:
    def __init__(
        self,
        server: APIServer,
        collectors: Sequence[object],
        debug_collectors: Sequence[str] = ("go",),
    ) -> None:
        self._server = server
        self._collectors = list(collectors)
        self._debug = list(debug_collectors)
        self._registry = CollectorRegistry()
        # classic-text scrapes render PowerCollectors via their direct
        # snapshot→text fast path and everything else through the registry;
        # ordering (power first) matches create_collectors' registration
        # order so the fast output is byte-identical to a full registry
        # render (tests/test_exporter_wire.py pins it)
        self._power = [c for c in self._collectors
                       if isinstance(c, PowerCollector)]
        self._aux_registry = CollectorRegistry()

    def name(self) -> str:
        return "prometheus-exporter"

    def init(self) -> None:
        # classic-text byte-identity with a full registry render requires
        # every PowerCollector to be registered BEFORE any aux collector
        # (the fast path concatenates power-then-aux); enforce rather than
        # assume create_collectors' ordering
        seen_aux = False
        for c in self._collectors:
            if isinstance(c, PowerCollector):
                if seen_aux:
                    raise ValueError(
                        "PowerCollector registered after a non-power "
                        "collector; the classic-text fast path renders "
                        "power families first, so this ordering would "
                        "change family order vs the stock renderer")
            else:
                seen_aux = True
        for c in self._collectors:
            self._registry.register(c)  # type: ignore[arg-type]
            if not isinstance(c, PowerCollector):
                self._aux_registry.register(c)  # type: ignore[arg-type]
        if "go" in self._debug or "process" in self._debug:
            # Python-runtime analog of the Go runtime collectors
            try:
                from prometheus_client import (
                    GC_COLLECTOR,
                    PLATFORM_COLLECTOR,
                    PROCESS_COLLECTOR,
                )
                for c in (GC_COLLECTOR, PLATFORM_COLLECTOR,
                          PROCESS_COLLECTOR):
                    for reg in (self._registry, self._aux_registry):
                        try:
                            reg.register(c)
                        except ValueError:
                            pass  # already registered into this registry
            except ImportError:  # pragma: no cover
                log.debug("runtime collectors unavailable")
        self._server.register(
            "/metrics", "Metrics", "Prometheus metrics", self._handle)
        log.info("prometheus exporter ready at /metrics")

    def _handle(self, request) -> tuple[int, dict[str, str], bytes]:
        # content negotiation (reference enables OpenMetrics on its
        # promhttp handler): serve the OpenMetrics exposition when the
        # scraper asks for it, classic text format otherwise. BOTH paths
        # use the collectors' direct fast render — modern Prometheus
        # negotiates OpenMetrics by default, so it is just as hot as
        # classic; only the tiny aux registry goes through the stock
        # renderer (which also supplies the `# EOF` terminator).
        from kepler_tpu_torch.exporter.prometheus.fastexpo import (
            wants_openmetrics,
        )

        # the scrape is its own telemetry cycle: kepler_self_stage_
        # duration_seconds{stage="exporter.scrape"} is the render cost a
        # Prometheus server actually pays per scrape
        with telemetry.span("exporter.scrape"):
            if wants_openmetrics(request):
                from prometheus_client.openmetrics import (
                    exposition as om_exposition,
                )
                payload = (b"".join(c.render_text(openmetrics=True)
                                    for c in self._power)
                           + om_exposition.generate_latest(
                               self._aux_registry))
                return (200,
                        {"Content-Type": om_exposition.CONTENT_TYPE_LATEST},
                        payload)
            payload = (b"".join(c.render_text() for c in self._power)
                       + fast_generate_latest(self._aux_registry))
            return 200, {"Content-Type": CONTENT_TYPE_LATEST}, payload

    @property
    def registry(self) -> CollectorRegistry:
        return self._registry


def make_registry_handler(registry: CollectorRegistry):
    """Generic /metrics handler over one registry with content
    negotiation, both formats on the fast renderers (byte-identical to
    the stock ones, with wholesale fallback). The aggregator's
    fleet-metrics endpoint uses this; the node exporter has its own
    handler because its power families bypass the registry entirely."""
    from prometheus_client.openmetrics import exposition as om_exposition

    from kepler_tpu_torch.exporter.prometheus.fastexpo import (
        fast_generate_openmetrics,
        wants_openmetrics,
    )

    def handler(request) -> tuple[int, dict[str, str], bytes]:
        with telemetry.span("exporter.scrape"):
            if wants_openmetrics(request):
                return (200,
                        {"Content-Type": om_exposition.CONTENT_TYPE_LATEST},
                        fast_generate_openmetrics(registry))
            return (200, {"Content-Type": CONTENT_TYPE_LATEST},
                    fast_generate_latest(registry))

    return handler
