"""Monitor watchdog: detects a stalled refresh loop.

The reference's failure model covers *failing* refreshes (skip-on-error
zone reads, serve-stale-on-error snapshots) but not a refresh loop that
stops running at all — a meter blocked in a driver read, an informer
deadlock, a wedged device call. This Runner closes that gap: it
periodically compares the monitor's last-completed-refresh age against a
stall threshold (default: 3 refresh intervals) and, when exceeded, marks
the published snapshot stale (``PowerMonitor.mark_stalled``) and flips
its own /healthz probe to degraded. A completed refresh clears the flag,
so recovery is automatic and the degraded window is exactly the stall.

The watchdog never restarts anything itself — pairing it with
``run_services(..., restart=RestartPolicy(...))`` is the supervised
variant (docs/developer/resilience.md).
"""

from __future__ import annotations

# keplint: monotonic-only — stall ages must survive NTP clock steps

import logging
import time as _time
from typing import Any, Callable

from kepler_tpu_torch import telemetry
from kepler_tpu_torch.monitor.monitor import PowerMonitor
from kepler_tpu_torch.service.lifecycle import CancelContext

log = logging.getLogger("kepler.monitor.watchdog")


class MonitorWatchdog:
    def __init__(
        self,
        monitor: PowerMonitor,
        interval: float,
        stall_after: float | None = None,
        check_every: float | None = None,
        monotonic: Callable[[], float] | None = None,
        journal: Any = None,
    ) -> None:
        """``interval`` is the monitor's refresh interval; ``stall_after``
        defaults to 3 intervals (the convergence budget),
        ``check_every`` to one interval. ``journal`` is an optional
        fleet black-box :class:`~kepler_tpu_torch.fleet.journal.EventJournal`
        — passed as an INSTANCE (never imported here) so the monitor
        binary does not import the journal when it is off."""
        self._monitor = monitor
        self._journal = journal
        self._interval = max(interval, 1e-3)
        self._stall_after = (stall_after if stall_after is not None
                             else 3.0 * self._interval)
        self._check_every = (check_every if check_every is not None
                             else self._interval)
        self._monotonic = monotonic or _time.monotonic
        self._started_at: float | None = None
        self._stall_count = 0
        # where the wedged refresh is stuck: the innermost open span of
        # the in-flight monitor.refresh cycle, snapshotted from the
        # telemetry plane when the stall is detected ("" when telemetry
        # is disabled or no refresh is in flight)
        self._stuck_stage = ""
        self._stall_spans: list[dict] = []

    def name(self) -> str:
        return "monitor-watchdog"

    def run(self, ctx: CancelContext) -> None:
        self._started_at = self._monotonic()
        while not ctx.cancelled():
            if ctx.wait(self._check_every):
                return
            self.check_once()

    def _age(self) -> float:
        """Seconds since the last completed refresh — or, before any
        refresh EVER completed, since watchdog start (the first refresh
        may be slow — device start-up — so the same threshold applies)."""
        age = self._monitor.last_refresh_age()
        if age is None:
            started = self._started_at
            if started is None:
                self._started_at = started = self._monotonic()
            age = self._monotonic() - started
        return age

    def check_once(self) -> bool:
        """One stall check (tests call this directly). True = stalled.

        Only ever SETS the stall flag — a completed refresh is what
        clears it (monitor._refresh_locked), so recovery is owned by the
        thing that actually recovered. The age is re-read right before
        flagging so a refresh completing mid-check can't get a
        just-recovered monitor re-marked stale."""
        stalled = self._age() > self._stall_after
        if stalled:
            stalled = self._age() > self._stall_after  # double-check
        if stalled:
            # snapshot the in-flight trace so the report names WHERE the
            # refresh is wedged, not just that it is (re-read every
            # check: the stall may progress into a deeper stage)
            self._stall_spans = self._inflight_refresh_spans()
            self._stuck_stage = (self._stall_spans[-1]["name"]
                                 if self._stall_spans else "")
            if not self._monitor.stalled:
                self._stall_count += 1
                log.error("monitor refresh loop stalled: last refresh "
                          "%.1fs ago (threshold %.1fs); marking snapshot "
                          "stale%s", self._age(), self._stall_after,
                          f" (stuck in {self._stuck_stage})"
                          if self._stuck_stage else "")
                if self._journal is not None:
                    # black box: FIRST detection only — the per-check
                    # repeat while still stalled is not a new event
                    self._journal.emit(
                        "watchdog.stall",
                        age_s=round(self._age(), 3),
                        threshold_s=round(self._stall_after, 3),
                        stuck_stage=self._stuck_stage)
            self._monitor.mark_stalled(True)
        return stalled

    @staticmethod
    def _inflight_refresh_spans() -> list[dict]:
        """Open spans of the in-flight monitor.refresh cycle (outermost
        first), [] when none / telemetry disabled."""
        for entry in telemetry.inflight():
            spans = entry.get("spans", [])
            if spans and spans[0]["name"] == "monitor.refresh":
                return spans
        return []

    def health(self) -> dict:
        """Probe for /healthz (degraded while the loop is stalled)."""
        out: dict = {"ok": not self._monitor.stalled,
                     "stalled": self._monitor.stalled,
                     "stalls_total": self._stall_count}
        if self._monitor.stalled and self._stuck_stage:
            out["stuck_stage"] = self._stuck_stage
            out["inflight_spans"] = [
                {"name": s["name"],
                 "elapsed_s": round(s["elapsed_s"], 3)}
                for s in self._stall_spans]
        age = self._monitor.last_refresh_age()
        if age is not None:
            out["last_refresh_age_s"] = round(age, 3)
        return out
