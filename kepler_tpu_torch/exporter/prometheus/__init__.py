"""Prometheus exposition (reference ``internal/exporter/prometheus/``).

Only what the aggregator binary serves: the registry handler, the fast
renderers and the info collectors. Importing this package imports
``prometheus_client``; the aggregator does so only when ``/metrics`` is on.
"""

from kepler_tpu_torch.exporter.prometheus.exporter import (
    make_registry_handler,
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
    "make_registry_handler",
]
