"""Node-agent entry point of the PyTorch/CUDA port.

Reference parity: ``cmd/kepler/main.go:27-65`` — parse flags+config, build
the service graph, sequential Init (rollback on failure), concurrent Run
(first exit cancels all), graceful shutdown on SIGINT/SIGTERM.

Run as ``python -m kepler_tpu_torch.cmd.main [flags]``: the same flags,
config file and service graph as ``python -m kepler_tpu.cmd.main``, plus
``--device {cuda,cpu}`` (default ``cuda``), the device the monitor's
attribution leg runs on. Without CUDA the binary logs an error naming
CUDA and exits with status 1; a GPU-less node runs it with ``--device
cpu``. ``tpu.compilationCacheDir`` has no counterpart (eager PyTorch
compiles nothing) and is ignored with one log line.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Sequence

import torch

from kepler_tpu_torch import fault, telemetry, version
from kepler_tpu_torch.config import Config, parse_args_and_config
from kepler_tpu_torch.cmd import split_device
from kepler_tpu_torch.device import resolve_device
from kepler_tpu_torch.device.fake import FakeCPUMeter
from kepler_tpu_torch.device.rapl import RaplPowerMeter
from kepler_tpu_torch.exporter.prometheus import (
    PrometheusExporter,
    create_collectors,
)
from kepler_tpu_torch.exporter.stdout import StdoutExporter
from kepler_tpu_torch.monitor.monitor import PowerMonitor
from kepler_tpu_torch.monitor.watchdog import MonitorWatchdog
from kepler_tpu_torch.resource import ResourceInformer, make_proc_reader
from kepler_tpu_torch.server.debug import DebugService
from kepler_tpu_torch.server.webconfig import make_api_server
from kepler_tpu_torch.service.lifecycle import (
    CancelContext,
    RestartPolicy,
    SignalHandler,
    init_services,
    run_services,
)
from kepler_tpu_torch.utils.logger import new_logger

log = logging.getLogger("kepler.main")


def _powercap_usable(sysfs: str) -> bool:
    powercap = os.path.join(sysfs, "class", "powercap")
    try:
        return any(e.startswith("intel-rapl") for e in os.listdir(powercap))
    except OSError:
        return False


def create_cpu_meter(cfg: Config):
    """reference createCPUMeter (main.go:227-241), extended with the MSR
    fallback the reference proposed (EP-002): powercap stays primary; MSR
    engages only when opted in AND powercap is unusable (or force, for
    testing)."""
    if cfg.dev.fake_cpu_meter.enabled:
        return FakeCPUMeter(zones=cfg.dev.fake_cpu_meter.zones)
    if cfg.msr.enabled:
        from kepler_tpu_torch.device.msr import MsrPowerMeter

        if cfg.msr.force:
            return MsrPowerMeter(device_path=cfg.msr.device_path,
                                 zone_filter=cfg.rapl.zones)
        if (not _powercap_usable(cfg.host.sysfs)
                and MsrPowerMeter.available(cfg.msr.device_path)):
            log.warning("powercap unusable under %s; falling back to the "
                        "MSR meter", cfg.host.sysfs)
            return MsrPowerMeter(device_path=cfg.msr.device_path,
                                 zone_filter=cfg.rapl.zones)
    return RaplPowerMeter(sysfs_path=cfg.host.sysfs,
                          zone_filter=cfg.rapl.zones)


def create_services(cfg: Config,
                    device: str | torch.device = "cuda") -> list:
    """reference createServices (main.go:124-225); ``device`` is where
    the monitor attributes (and the debug trace probes)."""
    if cfg.tpu.compilation_cache_dir:
        log.info("tpu.compilationCacheDir %s is ignored: eager PyTorch "
                 "compiles no programs to cache",
                 cfg.tpu.compilation_cache_dir)
    meter = create_cpu_meter(cfg)

    pod_lookup = None
    if cfg.kube.enabled:
        from kepler_tpu_torch.k8s.pod import PodInformer
        pod_lookup = PodInformer(
            node_name=cfg.kube.node_name, kubeconfig=cfg.kube.config)

    resources = ResourceInformer(reader=make_proc_reader(cfg.host.procfs),
                                 procfs_path=cfg.host.procfs,
                                 pod_lookup=pod_lookup)
    monitor = PowerMonitor(
        meter,
        resources,
        interval=cfg.monitor.interval,
        staleness=cfg.monitor.staleness,
        max_terminated=cfg.monitor.max_terminated,
        min_terminated_energy_uj=(
            cfg.monitor.min_terminated_energy_threshold * 1e6),
        workload_bucket=cfg.tpu.workload_bucket,
        state_path=cfg.monitor.state_path,
        state_max_age=cfg.monitor.state_max_age,
        device=device,
    )
    server = make_api_server(cfg.web.listen_addresses, cfg.web.config_file,
                             max_connections=cfg.web.max_connections)
    # self-telemetry: recent cycle traces (monitor refresh stages, scrape
    # renders, agent delivery legs) as JSON or Chrome trace-event format
    server.register("/debug/traces", "Traces",
                    "recent cycle span traces (?format=json|chrome; "
                    "chrome loads in Perfetto)",
                    telemetry.make_traces_handler())
    services: list = []
    if pod_lookup is not None:
        services.append(pod_lookup)
    services += [resources, monitor, server]
    if cfg.monitor.interval > 0:
        stall_journal = None
        if cfg.telemetry.journal.enabled:
            from kepler_tpu_torch.fleet import journal
            stall_journal = journal.active()
        watchdog = MonitorWatchdog(
            monitor, interval=cfg.monitor.interval,
            stall_after=cfg.monitor.stall_after or None,
            journal=stall_journal)
        services.append(watchdog)
        # ONE monitor probe: the watchdog's (stall flag + age + stall
        # count) supersedes monitor.health, which reads the same flag
        server.health.register_probe("monitor-watchdog", watchdog.health)
    else:
        server.health.register_probe("monitor", monitor.health)
    # ready once the first snapshot exists (collector readiness gate)
    server.health.register_readiness(
        "monitor", lambda: {"ok": monitor.data_channel().is_set()})
    agent = None
    spool_error = ""
    if cfg.aggregator.endpoint:
        from kepler_tpu_torch.fleet import FleetAgent, Spool
        from kepler_tpu_torch.parallel.fleet import MODE_MODEL, MODE_RATIO
        spool = None
        if cfg.agent.spool.dir:
            # durable delivery: windows survive agent crashes/aggregator
            # outages on disk and replay with their original identity.
            # An unopenable spool (read-only disk after a crash, bad
            # permissions) degrades to the in-memory ring — losing the
            # durability upgrade must never cost the power metrics too.
            try:
                spool = Spool(
                    cfg.agent.spool.dir,
                    max_bytes=cfg.agent.spool.max_bytes,
                    max_records=cfg.agent.spool.max_records,
                    segment_bytes=cfg.agent.spool.segment_bytes,
                    fsync=cfg.agent.spool.fsync,
                    fsync_interval=cfg.agent.spool.fsync_interval,
                )
            except OSError as err:
                spool_error = str(err)
                log.error("report spool %s unusable (%s); continuing "
                          "WITHOUT durable delivery (in-memory ring only)",
                          cfg.agent.spool.dir, err)
        agent = FleetAgent(
            monitor,
            endpoint=cfg.aggregator.endpoint,
            node_name=cfg.kube.node_name,
            mode=(MODE_MODEL if cfg.aggregator.node_mode == "model"
                  else MODE_RATIO),
            tls_skip_verify=cfg.aggregator.tls_skip_verify,
            backoff_initial=cfg.aggregator.backoff_initial,
            backoff_max=cfg.aggregator.backoff_max,
            breaker_threshold=cfg.aggregator.breaker_threshold,
            breaker_cooldown=cfg.aggregator.breaker_cooldown,
            flush_timeout_s=cfg.aggregator.flush_timeout,
            spool=spool,
            peers=cfg.aggregator.peers,
            drain_batch_max=cfg.agent.drain.batch_max,
            drain_replay_rps=cfg.agent.drain.replay_rps,
            drain_retry_after_max=cfg.agent.drain.retry_after_max,
            wire_version=cfg.agent.wire.version,
            keyframe_every=cfg.agent.wire.keyframe_every,
            wire_degraded_ttl=cfg.agent.wire.degraded_ttl,
        )
        server.health.register_probe("fleet-agent", agent.health)
        if spool is not None:
            server.health.register_probe("fleet-spool", agent.spool_health)
        elif spool_error:
            # the operator ASKED for durability and is not getting it —
            # /healthz must say so, not stay silently green
            server.health.register_probe(
                "fleet-spool",
                lambda: {"ok": False, "enabled": False,
                         "error": f"configured spool unusable: "
                                  f"{spool_error}"})
    if cfg.exporter.prometheus.enabled:
        source = {"rapl": "rapl-powercap", "rapl-msr": "rapl-msr",
                  "fake-cpu-meter": "fake"}.get(meter.name(), meter.name())
        collectors = create_collectors(
            monitor,
            node_name=cfg.kube.node_name,
            metrics_level=cfg.exporter.prometheus.metrics_level,
            procfs=cfg.host.procfs,
            meter_source=source,
        )
        from kepler_tpu_torch.exporter.prometheus import HealthCollector
        collectors.append(HealthCollector(server.health))
        # kepler_self_* families (stage histograms, cycle overruns)
        # scrape beside the power collectors; when telemetry is disabled
        # the recorder simply has no samples
        collectors.append(telemetry.collector())
        if cfg.telemetry.journal.enabled:
            # kepler_fleet_journal_* / HLC families (black box). The
            # import stays inside the gate: the fleet package imports the
            # aggregator and its device engines, and a journal-less
            # monitor must not pay that
            from kepler_tpu_torch.fleet import journal
            collectors.append(journal.collector())
        if agent is not None:
            # breaker-state gauge always; kepler_fleet_spool_* rides
            # along when a spool is configured
            collectors.append(agent)
        services.append(PrometheusExporter(
            server, collectors,
            debug_collectors=cfg.exporter.prometheus.debug_collectors))
    if cfg.debug.pprof.enabled:
        services.append(DebugService(server, device))
    if cfg.exporter.stdout.enabled:
        services.append(StdoutExporter(monitor))
    if agent is not None:
        services.append(agent)
    if cfg.aggregator.enabled:
        log.warning("aggregator.enabled is set — the aggregator role runs "
                    "as its own binary: python -m kepler_tpu_torch.cmd.aggregator")
    return services


def main(argv: Sequence[str] | None = None) -> int:
    try:
        device_name, argv = split_device(
            sys.argv[1:] if argv is None else argv)
        cfg = parse_args_and_config(argv)
    except (ValueError, OSError) as err:
        print(f"error: {err}", file=sys.stderr)
        return 1
    # stdout exporter owns stdout; logs move to stderr (main.go:34-38)
    stream = sys.stderr if cfg.exporter.stdout.enabled else sys.stdout
    new_logger(cfg.log.level, cfg.log.format, stream=stream)
    info = version.info()
    try:
        device = resolve_device(device_name)
    except RuntimeError as err:
        log.error("the monitor attributes on a CUDA device unless run "
                  "with --device cpu: %s", err)
        return 1
    log.info("kepler-tpu %s (%s, %s) on %s", info.version,
             info.python_version, info.platform,
             torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")

    try:
        fault.install_from_config(cfg.fault)
        telemetry.install_from_config(cfg.telemetry)
        if cfg.telemetry.journal.enabled:
            # black-box journal for the agent/monitor process (breaker,
            # spool rewind, watchdog stall events); lazy import — the
            # fleet package imports the aggregator and its device engines
            from kepler_tpu_torch.fleet import journal
            journal.install_from_config(
                cfg.telemetry, node=cfg.kube.node_name,
                max_drift_s=cfg.aggregator.hlc_max_drift)
        services = create_services(cfg, device)
    except Exception as err:
        log.error("failed to create services: %s", err)
        return 1
    signal_handler = SignalHandler()
    services.append(signal_handler)
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
