"""Fault injection: seedable, config-wired chaos harness for resilience
tests and soak runs (see docs/developer/resilience.md)."""

from kepler_tpu_torch.fault.plan import (
    KNOWN_SITES,
    SITE_CATALOG,
    FaultPlan,
    FaultSpec,
    active,
    fire,
    install,
    install_from_config,
    installed,
    uninstall,
)

__all__ = [
    "KNOWN_SITES",
    "SITE_CATALOG",
    "FaultPlan",
    "FaultSpec",
    "active",
    "fire",
    "install",
    "install_from_config",
    "installed",
    "uninstall",
]
