"""Health/readiness registry behind ``/healthz`` and ``/readyz``.

Kubernetes-style probe plane for both roles (node exporter and cluster
aggregator): components register cheap probe callables and the API server
exposes two endpoints —

- ``GET /healthz``: **degradation.** 200 when every registered health
  probe reports ``ok``; 503 with per-component JSON otherwise. Probes
  surface the resilience machinery's state: the fleet agent's circuit
  breaker, the monitor watchdog's stall detection, the aggregator's
  degraded-node quarantine accounting. NOTE: degradation includes
  EXTERNAL dependencies (an open circuit breaker means the aggregator is
  unreachable, not that this process is broken) — wire alerting and
  traffic gating to it, NOT a kubelet livenessProbe, which would
  restart-loop healthy exporters during an aggregator outage.
- ``GET /readyz``: **readiness.** 200 once every registered readiness
  probe reports ``ok`` (e.g. the monitor published its first snapshot,
  the aggregator finished init). With no readiness probes registered the
  endpoint reports ready — a bare APIServer that serves requests is ready.

Probe contract: a zero-argument callable returning a mapping with at
least ``{"ok": bool}``; extra keys are passed through as detail. A probe
that raises is reported as failed (the health plane itself must never
500 because a component is broken — that is exactly when it is needed).
"""

from __future__ import annotations

import json
import logging
import threading
from typing import Callable, Mapping

log = logging.getLogger("kepler.server.health")

Probe = Callable[[], Mapping]


class HealthRegistry:
    """Thread-safe probe registry; components register during init()."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._health: dict[str, Probe] = {}
        self._ready: dict[str, Probe] = {}

    def register_probe(self, name: str, probe: Probe) -> None:
        """Add a liveness/degradation probe (re-registration replaces)."""
        with self._lock:
            self._health[name] = probe

    def register_readiness(self, name: str, probe: Probe) -> None:
        with self._lock:
            self._ready[name] = probe

    def unregister(self, name: str) -> None:
        with self._lock:
            self._health.pop(name, None)
            self._ready.pop(name, None)

    @staticmethod
    def _run_probes(probes: dict[str, Probe]) -> tuple[bool, dict]:
        ok = True
        components: dict[str, dict] = {}
        for name, probe in probes.items():
            try:
                result = dict(probe())
                result["ok"] = bool(result.get("ok", False))
            except Exception as err:  # a broken probe is a failing probe
                log.exception("health probe %s raised", name)
                result = {"ok": False, "error": f"{type(err).__name__}: {err}"}
            ok = ok and result["ok"]
            components[name] = result
        return ok, components

    def check_health(self) -> tuple[bool, dict]:
        with self._lock:
            probes = dict(self._health)
        return self._run_probes(probes)

    def check_ready(self) -> tuple[bool, dict]:
        with self._lock:
            probes = dict(self._ready)
        return self._run_probes(probes)

    # -- endpoint handlers (APIServer handler signature) -------------------

    def handle_healthz(self, _request) -> tuple[int, dict[str, str], bytes]:
        ok, components = self.check_health()
        body = json.dumps({"status": "ok" if ok else "degraded",
                           "components": components},
                          sort_keys=True).encode() + b"\n"
        return (200 if ok else 503,
                {"Content-Type": "application/json"}, body)

    def handle_readyz(self, _request) -> tuple[int, dict[str, str], bytes]:
        ok, components = self.check_ready()
        body = json.dumps({"status": "ok" if ok else "unready",
                           "components": components},
                          sort_keys=True).encode() + b"\n"
        return (200 if ok else 503,
                {"Content-Type": "application/json"}, body)
