"""Debug/profiling endpoints.

Reference parity: ``internal/server/pprof.go`` mounts ``net/http/pprof``
under ``/debug/pprof/`` when ``debug.pprof`` is enabled. The Python analog
serves:

- ``/debug/pprof/``         — index of available profiles
- ``/debug/pprof/stack``    — live stack dump of every thread (goroutine
                              profile analog)
- ``/debug/pprof/profile``  — sampling CPU profile across ALL threads
                              (?seconds=N&hz=M); aggregates
                              ``sys._current_frames()`` samples, so it sees
                              the monitor/exporter threads, which a
                              per-thread cProfile cannot
- ``/debug/pprof/torch``    — one-shot ``torch.profiler`` trace of 0.5 s
                              (every thread's host ranges and, on the
                              card, device activity) to
                              a Chrome-trace file in a temp dir (loads in
                              Perfetto); the reference package serves a
                              JAX profiler trace here as ``/debug/pprof/jax``
"""

from __future__ import annotations

# keplint: monotonic-only — profile/trace deadlines use elapsed time

import collections
import io
import os
import math
import sys
import tempfile
import threading
import time
import traceback
from urllib.parse import parse_qs, urlparse

import torch

from kepler_tpu_torch.server.http import APIServer


class DebugService:
    def __init__(self, server: APIServer,
                 device: str | torch.device) -> None:
        """``device`` is where the trace's probe op runs: the node
        binary passes its monitor's device."""
        self._server = server
        self._device = torch.device(device)

    def name(self) -> str:
        return "pprof"

    def init(self) -> None:
        self._server.register("/debug/pprof/", "Profiling",
                              "pprof-style debug profiles", self._handle)

    def _handle(self, request) -> tuple[int, dict[str, str], bytes]:
        url = urlparse(request.path)
        parts = [p for p in url.path.split("/") if p]
        which = parts[2] if len(parts) > 2 else "index"
        if which == "stack":
            return self._stacks()
        if which == "profile":
            qs = parse_qs(url.query)
            # query values come off the wire: a non-numeric (or NaN/inf)
            # seconds/hz must be a 400, never a traceback into the
            # server's generic 500 handler
            try:
                seconds = float(qs.get("seconds", ["5"])[0])
                hz = float(qs.get("hz", ["100"])[0])
            except ValueError:
                return (400, {"Content-Type": "text/plain"},
                        b"seconds/hz must be numeric\n")
            if not (math.isfinite(seconds) and math.isfinite(hz)):
                return (400, {"Content-Type": "text/plain"},
                        b"seconds/hz must be finite\n")
            return self._profile(min(max(seconds, 0.0), 60.0),
                                 min(max(hz, 1.0), 1000.0))
        if which == "torch":
            return self._torch_trace()
        body = (
            "<html><body><h1>debug/pprof</h1><ul>"
            '<li><a href="/debug/pprof/stack">stack</a></li>'
            '<li><a href="/debug/pprof/profile?seconds=5">profile</a></li>'
            '<li><a href="/debug/pprof/torch">torch trace</a></li>'
            "</ul>"
            "<h2>other debug surfaces</h2><ul>"
            '<li><a href="/debug/traces">traces</a> — recent cycle span '
            "traces (?format=chrome loads in Perfetto)</li>"
            '<li><a href="/debug/window">window</a> — device-plane '
            "introspection: rung + timeline, shards, compile-cache cost "
            "stats (aggregator role)</li>"
            '<li><a href="/debug/fleet">fleet</a> — per-node scoreboard '
            "(aggregator role)</li>"
            '<li><a href="/debug/journal">journal</a> — fleet black box: '
            "HLC-stamped causal event journal (?since=&lt;cursor&gt; "
            "paginates)</li>"
            '<li><a href="/debug/bundle">bundle</a> — one-shot incident '
            "snapshot (feed to python -m kepler_tpu_torch.blackbox)</li>"
            "</ul></body></html>"
        ).encode()
        return 200, {"Content-Type": "text/html"}, body

    @staticmethod
    def _stacks() -> tuple[int, dict[str, str], bytes]:
        out = io.StringIO()
        frames = sys._current_frames()
        for thread in threading.enumerate():
            frame = frames.get(thread.ident)
            out.write(f"--- thread {thread.name} (id {thread.ident}) ---\n")
            if frame:
                traceback.print_stack(frame, file=out)
            out.write("\n")
        return 200, {"Content-Type": "text/plain"}, out.getvalue().encode()

    @staticmethod
    def _profile(seconds: float, hz: float
                 ) -> tuple[int, dict[str, str], bytes]:
        """Statistical profile: sample every thread's stack at ``hz``."""
        own = threading.get_ident()
        counts: collections.Counter[tuple[str, ...]] = collections.Counter()
        samples = 0
        deadline = time.monotonic() + seconds
        period = 1.0 / hz
        while time.monotonic() < deadline:
            for tid, frame in sys._current_frames().items():
                if tid == own:
                    continue
                stack = []
                f = frame
                while f is not None and len(stack) < 24:
                    code = f.f_code
                    stack.append(f"{code.co_filename.rsplit('/', 1)[-1]}:"
                                 f"{f.f_lineno} {code.co_name}")
                    f = f.f_back
                counts[tuple(reversed(stack))] += 1
            samples += 1
            time.sleep(period)
        out = io.StringIO()
        out.write(f"sampling profile: {samples} samples over {seconds}s "
                  f"at {hz:g} Hz (all threads except handler)\n\n")
        for stack, n in counts.most_common(40):
            out.write(f"{n}/{samples} samples ({n / max(samples, 1):.1%}):\n")
            for line in stack:
                out.write(f"    {line}\n")
            out.write("\n")
        return 200, {"Content-Type": "text/plain"}, out.getvalue().encode()

    def _torch_trace(self) -> tuple[int, dict[str, str], bytes]:
        from torch.profiler import (ProfilerActivity, _ExperimentalConfig,
                                    profile)

        activities = [ProfilerActivity.CPU]
        if self._device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        trace_dir = tempfile.mkdtemp(prefix="kepler-torch-trace-")
        every_thread = _ExperimentalConfig(profile_all_threads=True)
        with profile(activities=activities,
                     experimental_config=every_thread) as prof:
            # one trivial device op so the trace isn't empty. Attribution
            # windows in these 0.5 s land in it too: their device work and
            # their host ranges (the fleet.* spans, PyTorch's operators),
            # since every thread's host ranges are recorded
            torch.zeros(8, device=self._device).add_(1.0).sum().item()
            time.sleep(0.5)
        path = os.path.join(trace_dir, "trace.json")
        prof.export_chrome_trace(path)
        msg = f"torch trace written to {path}\n"
        return 200, {"Content-Type": "text/plain"}, msg.encode()
