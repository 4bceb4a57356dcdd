"""HTTP API server (reference ``internal/server/``)."""

from kepler_tpu_torch.server.http import APIServer

__all__ = ["APIServer"]
