"""Build-info and CPU-info collectors.

Reference parity: ``collector/build_info.go:21-53`` (``kepler_build_info``
gauge with arch/branch/revision/version labels) and ``collector/cpuinfo.go:
44-63`` (``kepler_node_cpu_info`` from ``/proc/cpuinfo``).
"""

from __future__ import annotations

import os
import platform

from prometheus_client.core import GaugeMetricFamily

from kepler_tpu_torch import version


class BuildInfoCollector:
    def collect(self):
        info = version.info()
        family = GaugeMetricFamily(
            "kepler_build_info",
            "A metric with a constant '1' value labeled by version info "
            "from which kepler was built",
            labels=["arch", "branch", "revision", "version", "goversion"])
        family.add_metric(
            [platform.machine(), info.git_branch, info.git_commit,
             info.version, f"python{info.python_version}"],
            1.0)
        yield family


class PowerMeterInfoCollector:
    """``kepler_node_cpu_power_meter{source=...} 1`` — which hardware
    backend feeds attribution (reference proposal EP-002 §Metrics:
    ``rapl-powercap`` vs ``rapl-msr``; plus ``fake`` for the dev meter).
    """

    def __init__(self, source: str) -> None:
        self._source = source

    def collect(self):
        family = GaugeMetricFamily(
            "kepler_node_cpu_power_meter",
            "A metric with a constant '1' value labeled by the active "
            "CPU power meter backend",
            labels=["source"])
        family.add_metric([self._source], 1.0)
        yield family


class HealthCollector:
    """``kepler_component_healthy{component=...}`` gauges from the API
    server's health registry — the same probes behind ``/healthz``
    (agent circuit breaker, monitor watchdog, aggregator quarantine)
    exposed on the scrape plane so degradation is alertable without a
    separate probe poller."""

    def __init__(self, health) -> None:
        self._health = health

    def collect(self):
        family = GaugeMetricFamily(
            "kepler_component_healthy",
            "1 while the component's health probe reports ok, else 0",
            labels=["component"])
        _, components = self._health.check_health()
        for name, result in sorted(components.items()):
            family.add_metric([name], 1.0 if result.get("ok") else 0.0)
        yield family


class CPUInfoCollector:
    def __init__(self, procfs: str = "/proc") -> None:
        self._path = os.path.join(procfs, "cpuinfo")

    def _cpus(self):
        cpus: list[dict[str, str]] = []
        current: dict[str, str] = {}
        try:
            with open(self._path, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        if current:
                            cpus.append(current)
                            current = {}
                        continue
                    if ":" in line:
                        k, _, v = line.partition(":")
                        current[k.strip()] = v.strip()
        except OSError:
            return []
        if current:
            cpus.append(current)
        return cpus

    def collect(self):
        family = GaugeMetricFamily(
            "kepler_node_cpu_info",
            "CPU information from procfs",
            labels=["processor", "vendor_id", "model_name", "physical_id",
                    "core_id"])
        for cpu in self._cpus():
            family.add_metric(
                [cpu.get("processor", ""), cpu.get("vendor_id", ""),
                 cpu.get("model name", ""), cpu.get("physical id", ""),
                 cpu.get("core id", "")],
                1.0)
        yield family
