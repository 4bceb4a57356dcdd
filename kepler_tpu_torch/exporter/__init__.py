"""Exporters (reference ``internal/exporter/``)."""

from kepler_tpu_torch.exporter.stdout import StdoutExporter

__all__ = ["StdoutExporter"]
