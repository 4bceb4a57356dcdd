"""Cluster-aggregator entry point, on one CUDA device (or the CPU).

``python -m kepler_tpu_torch.cmd.aggregator`` starts the fleet ingest and
attribution service of the PyTorch/CUDA port: the same flags, config
file and HTTP surface as ``python -m kepler_tpu.cmd.aggregator``, plus
``--device {cuda,cpu}`` (default ``cuda``). Node agents point at it via
``--aggregator.endpoint``. Without CUDA it exits with status 1 naming
CUDA unless run with ``--device cpu``; the sharded and
multi-host tiers (``aggregator.meshShape`` over several devices,
``aggregator.multihost``) are not yet ported and fail at start-up.
``--tpu.fleet-backend pallas`` runs the hand-written CUDA kernels.

``yaml`` is imported only to read a config file or a web config file,
and ``prometheus_client`` only when ``/metrics`` is on
(``exporter.prometheus.enabled``).
"""

from __future__ import annotations

import logging
import sys
from typing import Sequence

import torch

from kepler_tpu_torch import version
from kepler_tpu_torch.cmd import split_device
from kepler_tpu_torch.config import parse_args_and_config
from kepler_tpu_torch.device import resolve_device
from kepler_tpu_torch.fleet import Aggregator
from kepler_tpu_torch.service.lifecycle import (
    CancelContext,
    RestartPolicy,
    SignalHandler,
    init_services,
    run_services,
)
from kepler_tpu_torch.utils.logger import new_logger

log = logging.getLogger("kepler.aggregator")


def main(argv: Sequence[str] | None = None) -> int:
    try:
        device_name, argv = split_device(
            sys.argv[1:] if argv is None else argv)
        cfg = parse_args_and_config(argv, skip_validation=("host",))
        # the aggregator binary IS the replica role regardless of the
        # aggregator.enabled flag (which gates the node binary's embedded
        # aggregator) — ring membership must be coherent here too, as a
        # friendly startup error rather than a constructor traceback
        if cfg.aggregator.peers and not cfg.aggregator.self_peer:
            raise ValueError("aggregator.selfPeer must name this replica "
                             "when aggregator.peers is set")
    except (ValueError, OSError) as err:
        print(f"error: {err}", file=sys.stderr)
        return 1
    new_logger(cfg.log.level, cfg.log.format)
    from kepler_tpu_torch import fault, telemetry
    fault.install_from_config(cfg.fault)
    telemetry.install_from_config(cfg.telemetry)
    try:
        device = resolve_device(device_name)
    except RuntimeError as err:
        log.error("the aggregator serves on a CUDA device unless run "
                  "with --device cpu: %s", err)
        return 1
    info = version.info()
    log.info("kepler-tpu aggregator %s (%s, %s) on %s", info.version,
             info.python_version, info.platform,
             torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")

    params = None
    if cfg.aggregator.params_path:
        from kepler_tpu_torch.models.estimator import load_params
        params = load_params(cfg.aggregator.params_path)
        log.info("loaded %s params from %s", cfg.aggregator.model,
                 cfg.aggregator.params_path)

    from kepler_tpu_torch.server.webconfig import make_api_server
    server = make_api_server([cfg.aggregator.listen_address],
                             cfg.web.config_file,
                             max_connections=cfg.web.max_connections)
    # fleet black box: one journal per replica, installed process-wide
    # (module emit sites) AND handed to the Aggregator (its /debug
    # surfaces + metric families ride the aggregator's registration)
    from kepler_tpu_torch.fleet import journal as journal_mod
    jnl = journal_mod.install_from_config(
        cfg.telemetry,
        node=(cfg.aggregator.self_peer or cfg.aggregator.listen_address),
        max_drift_s=cfg.aggregator.hlc_max_drift)
    aggregator = Aggregator(
        server,
        interval=cfg.aggregator.interval,
        stale_after=cfg.aggregator.stale_after,
        model_mode=cfg.aggregator.model or None,
        model_params=params,
        node_bucket=cfg.tpu.node_bucket,
        workload_bucket=cfg.tpu.workload_bucket,
        backend=cfg.tpu.fleet_backend,
        accuracy_mode=cfg.aggregator.accuracy_mode,
        history_window=cfg.aggregator.history_window,
        training_dump_dir=cfg.aggregator.training_dump_dir,
        training_dump_max_files=cfg.aggregator.training_dump_max_files,
        skew_tolerance=cfg.aggregator.skew_tolerance,
        degraded_ttl=cfg.aggregator.degraded_ttl,
        dedup_window=cfg.aggregator.dedup_window,
        delivery_buckets=cfg.telemetry.delivery_buckets or None,
        pipeline_depth=cfg.aggregator.pipeline_depth,
        fused_window_k=cfg.aggregator.fused_window_k,
        bucket_shrink_after=cfg.aggregator.bucket_shrink_after,
        fallback_enabled=cfg.aggregator.fallback_enabled,
        repromote_after=cfg.aggregator.repromote_after,
        dispatch_timeout=cfg.aggregator.dispatch_timeout,
        mesh_shape=cfg.aggregator.mesh_shape,
        multihost_enabled=cfg.aggregator.multihost.enabled,
        multihost_takeover=cfg.aggregator.multihost.takeover,
        membership_auto_apply=cfg.aggregator.membership.auto_apply,
        membership_autoscale=cfg.aggregator.membership.autoscale_enabled,
        membership_scale_up_load=cfg.aggregator.membership.scale_up_load,
        membership_scale_down_load=(
            cfg.aggregator.membership.scale_down_load),
        membership_up_windows=cfg.aggregator.membership.up_windows,
        membership_down_windows=cfg.aggregator.membership.down_windows,
        membership_min_replicas=cfg.aggregator.membership.min_replicas,
        membership_max_replicas=cfg.aggregator.membership.max_replicas,
        membership_standby_peers=cfg.aggregator.membership.standby_peers,
        membership_probe_timeout=cfg.aggregator.membership.probe_timeout,
        scoreboard_cap=cfg.aggregator.scoreboard_cap,
        anomaly_z=cfg.aggregator.anomaly_z,
        peers=cfg.aggregator.peers,
        self_peer=cfg.aggregator.self_peer,
        ring_epoch=cfg.aggregator.ring_epoch,
        ring_vnodes=cfg.aggregator.ring_vnodes,
        admission_enabled=cfg.aggregator.admission_enabled,
        admission_max_inflight=cfg.aggregator.admission_max_inflight,
        admission_latency_budget=cfg.aggregator.admission_latency_budget,
        admission_retry_after=cfg.aggregator.admission_retry_after,
        admission_retry_after_max=(
            cfg.aggregator.admission_retry_after_max),
        base_row_cache=cfg.aggregator.base_row_cache,
        journal=jnl,
        hlc_max_drift=cfg.aggregator.hlc_max_drift,
        device=device,
    )
    # self-telemetry traces (ingest/decode/merge, window cycles)
    server.register("/debug/traces", "Traces",
                    "recent cycle span traces (?format=json|chrome; "
                    "chrome loads in Perfetto)",
                    telemetry.make_traces_handler())
    services: list = [server, aggregator]

    if cfg.exporter.prometheus.enabled:
        from prometheus_client import CollectorRegistry

        from kepler_tpu_torch.exporter.prometheus.exporter import (
            make_registry_handler,
        )
        registry = CollectorRegistry()
        registry.register(aggregator)
        from kepler_tpu_torch.exporter.prometheus import HealthCollector
        registry.register(HealthCollector(server.health))
        registry.register(telemetry.collector())
        # the fast renderers in BOTH negotiated formats (byte-identical
        # to the stock ones; fastexpo falls back wholesale on anything
        # beyond the simple kepler families)
        server.register("/metrics", "Metrics",
                        "Fleet-level Prometheus metrics",
                        make_registry_handler(registry))

    services.append(SignalHandler())
    try:
        init_services(services)
    except Exception as err:
        log.error("initialization failed: %s", err)
        return 1
    ctx = CancelContext()
    try:
        run_services(ctx, services,
                     restart=RestartPolicy.from_config(cfg.service))
    except Exception as err:
        log.error("run failed: %s", err)
        return 1
    log.info("Graceful shutdown completed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
