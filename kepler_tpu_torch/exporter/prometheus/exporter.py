"""Prometheus exposition for the fleet aggregator's ``/metrics``.

A partial copy of the reference package's ``exporter/prometheus/exporter.py``:
only :func:`make_registry_handler`, the handler the aggregator binary
serves its registry with. The node agent's ``PrometheusExporter`` comes
with the node-agent slice of the port.
"""

from __future__ import annotations

from prometheus_client import CollectorRegistry
from prometheus_client.exposition import CONTENT_TYPE_LATEST

from kepler_tpu_torch import telemetry
from kepler_tpu_torch.exporter.prometheus.fastexpo import fast_generate_latest


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
