"""Self-telemetry plane: span tracing, self-metrics, trace export.

See :mod:`kepler_tpu_torch.telemetry.spans` for the model and cost contract.
"""

from kepler_tpu_torch.telemetry.spans import (
    DEFAULT_DELIVERY_BUCKETS,
    DEFAULT_RING_SIZE,
    DEFAULT_STAGE_BUCKETS,
    CycleTrace,
    Histogram,
    SelfMetricsCollector,
    SpanEvent,
    SpanRecorder,
    collector,
    inflight,
    install,
    install_from_config,
    installed,
    make_traces_handler,
    recent_traces,
    recorder,
    span,
)

__all__ = [
    "DEFAULT_DELIVERY_BUCKETS",
    "DEFAULT_RING_SIZE",
    "DEFAULT_STAGE_BUCKETS",
    "CycleTrace",
    "Histogram",
    "SelfMetricsCollector",
    "SpanEvent",
    "SpanRecorder",
    "collector",
    "inflight",
    "install",
    "install_from_config",
    "installed",
    "make_traces_handler",
    "recent_traces",
    "recorder",
    "span",
]
