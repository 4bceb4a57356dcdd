"""Shared utilities: logging, the dense row store."""

from kepler_tpu_torch.utils.logger import new_logger

__all__ = ["new_logger"]
