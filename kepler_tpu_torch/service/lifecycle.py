"""Service lifecycle framework.

Reference parity: ``internal/service/`` — duck-typed lifecycle where a
"service" optionally implements Init / Run / Shutdown:

- ``init_services``: sequential Init; on the first failure, already-initialized
  services are shut down in reverse order (rollback;
  ``internal/service/initializer.go:15-58``).
- ``run_services``: concurrent Run, one thread per Runner; the first Runner to
  return (or raise) cancels the shared context, interrupting all others, then
  every service's Shutdown runs (``internal/service/run.go:16-65``, modeled on
  oklog/run).
- ``SignalHandler``: a Runner that exits on SIGINT/SIGTERM
  (``internal/service/signal_handler.go:13-39``).

Python idiom: instead of Go interfaces we use runtime ``hasattr`` duck typing
plus a ``CancelContext`` (threading.Event-backed) standing in for Go's
context cancellation.
"""

from __future__ import annotations

# keplint: monotonic-only — restart backoff schedules must survive NTP steps

import logging
import random
import signal
import threading
from dataclasses import dataclass
from typing import Protocol, Sequence, runtime_checkable

log = logging.getLogger("kepler.service")


class CancelContext:
    """Cooperative cancellation token shared by all running services."""

    def __init__(self) -> None:
        self._event = threading.Event()

    def cancel(self) -> None:
        self._event.set()

    def cancelled(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        """Block until cancelled (or timeout); returns True if cancelled."""
        return self._event.wait(timeout)


@runtime_checkable
class Service(Protocol):
    """Every service has a name (reference service.go:9-12)."""

    def name(self) -> str: ...


class ServiceError(Exception):
    pass


def backoff_with_jitter(initial: float, cap: float, attempt: int,
                        rng: random.Random) -> float:
    """Equal-jitter exponential backoff: ``min(cap, initial·2^(n-1))``,
    half deterministic + half random. The ONE schedule shared by the
    restart policy and the fleet agent's send retries — the jitter keeps
    a fleet of restarting/retrying nodes from synchronizing against a
    recovering dependency."""
    base = min(cap, initial * (2 ** max(0, attempt - 1)))
    return base / 2 + rng.uniform(0, base / 2)


@dataclass(frozen=True)
class RestartPolicy:
    """Supervised restart-with-backoff for ``run_services`` Runners.

    A Runner that RAISES is restarted after an exponential backoff with
    jitter, up to ``max_restarts`` times per service; only when a service
    exhausts its budget does the group fail. A Runner that RETURNS cleanly
    still cancels the whole group (the oklog/run semantics are unchanged —
    a deliberate exit, e.g. the SignalHandler, must keep meaning
    "shut everything down").

    The restart counter is per service and never resets: a service that
    crashes ``max_restarts + 1`` times over any span ends the group. That
    keeps the policy a bounded self-heal for transient faults (meter
    hiccup, aggregator hiccup), not a crash-loop hider.
    """

    max_restarts: int = 3
    backoff_initial: float = 0.5
    backoff_max: float = 30.0
    seed: int | None = None

    def backoff(self, attempt: int, rng: random.Random) -> float:
        """Delay before restart ``attempt`` (1-based), equal-jittered."""
        return backoff_with_jitter(self.backoff_initial, self.backoff_max,
                                   attempt, rng)

    @staticmethod
    def from_config(service_cfg) -> "RestartPolicy | None":
        """Policy from a ``ServiceConfig`` (None = reference semantics).
        Shared by both binaries; duck-typed so lifecycle stays decoupled
        from the config package."""
        if service_cfg.restart_max <= 0:
            return None
        return RestartPolicy(
            max_restarts=service_cfg.restart_max,
            backoff_initial=service_cfg.restart_backoff_initial,
            backoff_max=service_cfg.restart_backoff_max,
        )


def init_services(services: Sequence[Service]) -> None:
    """Sequentially Init services; roll back (Shutdown) on first failure.

    Reference ``internal/service/initializer.go:15-58``.
    """
    initialized: list[Service] = []
    for svc in services:
        init = getattr(svc, "init", None)
        if init is None:
            continue
        try:
            log.debug("initializing service", extra={"service": svc.name()})
            # one telemetry cycle per service init: slow startups (XLA
            # warmup, spool recovery scans) become visible stages in
            # /debug/traces instead of an opaque boot delay
            from kepler_tpu_torch import telemetry
            with telemetry.span(f"service.init.{svc.name()}"):
                init()
            initialized.append(svc)
        except Exception as err:
            log.error("initialization failed for %s: %s", svc.name(), err)
            for done in reversed(initialized):
                shutdown = getattr(done, "shutdown", None)
                if shutdown is None:
                    continue
                try:
                    shutdown()
                except Exception as rollback_err:  # best-effort rollback
                    log.warning(
                        "rollback shutdown of %s failed: %s",
                        done.name(), rollback_err,
                    )
            raise ServiceError(
                f"failed to initialize service {svc.name()}: {err}"
            ) from err


def run_services(ctx: CancelContext, services: Sequence[Service],
                 restart: RestartPolicy | None = None) -> None:
    """Run all Runner services concurrently until the first one returns.

    Semantics (reference ``internal/service/run.go:16-65`` / oklog/run):
    each Runner gets a thread running ``svc.run(ctx)``; when any returns or
    raises, the shared ctx is cancelled so all others unwind; finally every
    service's ``shutdown()`` runs (reverse order). The first error is raised.

    With a ``restart`` policy, a Runner that raises is instead restarted
    after a jittered exponential backoff, up to ``restart.max_restarts``
    times per service — the supervised mode (restart-with-backoff).
    Clean returns and exhausted budgets end the group as before.
    """
    runners = [s for s in services if hasattr(s, "run")]
    first_error: list[BaseException] = []
    done = threading.Event()
    threads: list[threading.Thread] = []
    rng = random.Random(restart.seed) if restart is not None else None

    def actor(svc: Service) -> None:
        attempts = 0
        try:
            while True:
                try:
                    svc.run(ctx)  # type: ignore[attr-defined]
                    return  # clean return: deliberate group shutdown
                except Exception as err:
                    if restart is not None and not ctx.cancelled() \
                            and attempts < restart.max_restarts:
                        attempts += 1
                        delay = restart.backoff(attempts, rng)
                        log.warning(
                            "service %s crashed (%s); restart %d/%d in "
                            "%.2fs", svc.name(), err, attempts,
                            restart.max_restarts, delay)
                        if ctx.wait(delay):
                            return
                        continue
                    if not first_error:
                        first_error.append(err)
                    log.error("service %s exited with error: %s",
                              svc.name(), err)
                    return
        finally:
            done.set()  # first (final) return interrupts the whole group

    try:
        for svc in runners:
            t = threading.Thread(target=actor, args=(svc,),
                                 name=f"svc-{svc.name()}", daemon=True)
            t.start()
            threads.append(t)
        if runners:
            done.wait()
    finally:
        ctx.cancel()
        for t in threads:
            t.join(timeout=10.0)
        for svc in reversed(list(services)):
            shutdown = getattr(svc, "shutdown", None)
            if shutdown is None:
                continue
            try:
                shutdown()
            except Exception as err:
                log.warning("shutdown of %s failed: %s", svc.name(), err)
    if first_error:
        raise ServiceError("service group failed") from first_error[0]


class SignalHandler:
    """A Runner that returns when SIGINT/SIGTERM arrives.

    Reference ``internal/service/signal_handler.go:13-39``.

    CPython only installs signal handlers on the main thread, but Runners
    execute on worker threads — so handlers are installed during ``init()``
    (``init_services`` runs sequentially on the caller's thread, normally
    main) and ``run()`` merely waits on the event. Off the main thread,
    installation degrades to waiting for programmatic ``trigger()``.
    """

    def __init__(self, signals: Sequence[int] = (signal.SIGINT, signal.SIGTERM)):
        self._signals = tuple(signals)
        self._received = threading.Event()
        self._previous: dict[int, object] = {}

    def name(self) -> str:
        return "signal-handler"

    def init(self) -> None:
        if threading.current_thread() is not threading.main_thread():
            log.warning("not on main thread; OS signals will not be caught")
            return
        for sig in self._signals:
            self._previous[sig] = signal.signal(
                sig, lambda *_: self._received.set()
            )

    def run(self, ctx: CancelContext) -> None:
        while not ctx.cancelled():
            if self._received.wait(0.2):
                log.info("received shutdown signal")
                return

    def shutdown(self) -> None:
        if threading.current_thread() is not threading.main_thread():
            return
        for sig, handler in self._previous.items():
            signal.signal(sig, handler)  # type: ignore[arg-type]
        self._previous.clear()

    def trigger(self) -> None:
        """Programmatic shutdown (tests)."""
        self._received.set()
