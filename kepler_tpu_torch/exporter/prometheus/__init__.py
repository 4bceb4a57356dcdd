"""Prometheus exporter (reference ``internal/exporter/prometheus/``)."""

from kepler_tpu_torch.exporter.prometheus.collector import PowerCollector
from kepler_tpu_torch.exporter.prometheus.exporter import (
    PrometheusExporter,
    create_collectors,
)
from kepler_tpu_torch.exporter.prometheus.info_collectors import (
    BuildInfoCollector,
    CPUInfoCollector,
    HealthCollector,
)

__all__ = [
    "BuildInfoCollector",
    "CPUInfoCollector",
    "HealthCollector",
    "PowerCollector",
    "PrometheusExporter",
    "create_collectors",
]
