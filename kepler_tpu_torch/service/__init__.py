"""Service lifecycle framework (reference ``internal/service/``)."""

from kepler_tpu_torch.service.lifecycle import (
    CancelContext,
    RestartPolicy,
    Service,
    ServiceError,
    SignalHandler,
    init_services,
    run_services,
)

__all__ = [
    "CancelContext",
    "RestartPolicy",
    "Service",
    "ServiceError",
    "SignalHandler",
    "init_services",
    "run_services",
]
