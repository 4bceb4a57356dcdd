"""Exporters: the fleet aggregator's Prometheus exposition."""
