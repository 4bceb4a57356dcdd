"""Stdout exporter: periodic terminal table of node power.

Reference parity: ``internal/exporter/stdout/stdout.go`` — a 2 s ticker dumps
a table of node zone energy/power (tablewriter); when enabled, application
logs move to stderr so the table stays readable
(``cmd/kepler/main.go:34-38`` — handled by the CLI).
"""

from __future__ import annotations

import sys
from typing import IO

from kepler_tpu_torch.device.energy import JOULE, WATT
from kepler_tpu_torch.monitor.monitor import PowerMonitor
from kepler_tpu_torch.service.lifecycle import CancelContext


def _render_table(headers: list[str], rows: list[list[str]]) -> str:
    widths = [len(h) for h in headers]
    for row in rows:
        for i, cell in enumerate(row):
            widths[i] = max(widths[i], len(cell))

    def line(cells, fill=" "):
        return ("| " + " | ".join(
            c.ljust(w, fill) for c, w in zip(cells, widths)) + " |")

    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    out = [sep, line(headers), sep]
    out += [line(r) for r in rows]
    out.append(sep)
    return "\n".join(out)


class StdoutExporter:
    def __init__(
        self,
        monitor: PowerMonitor,
        interval: float = 2.0,
        writer: IO[str] | None = None,
    ) -> None:
        self._monitor = monitor
        self._interval = interval
        self._writer = writer or sys.stdout

    def name(self) -> str:
        return "stdout-exporter"

    def run(self, ctx: CancelContext) -> None:
        # wait for the first snapshot before printing anything
        while not ctx.cancelled():
            if self._monitor.data_channel().wait(0.2):
                break
        while not ctx.cancelled():
            self.write_once()
            if ctx.wait(self._interval):
                return

    def write_once(self) -> None:
        snap = self._monitor.snapshot()
        node = snap.node
        rows = []
        for z, zone in enumerate(node.zone_names):
            rows.append([
                zone,
                f"{node.energy_uj[z] / JOULE:.2f}",
                f"{node.power_uw[z] / WATT:.2f}",
                f"{node.active_power_uw[z] / WATT:.2f}",
                f"{node.idle_power_uw[z] / WATT:.2f}",
            ])
        table = _render_table(
            ["Zone", "Energy (J)", "Power (W)", "Active (W)", "Idle (W)"],
            rows)
        counts = (f"workloads: {len(snap.processes)} procs, "
                  f"{len(snap.containers)} containers, "
                  f"{len(snap.virtual_machines)} vms, {len(snap.pods)} pods; "
                  f"cpu usage {node.usage_ratio:.1%}")
        print(table, file=self._writer)
        print(counts + "\n", file=self._writer, flush=True)

    def shutdown(self) -> None:
        try:
            self._writer.flush()
        except ValueError:  # closed writer
            pass
