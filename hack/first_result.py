"""Time from a node binary's readiness to its first aggregator result.

    python hack/first_result.py [--interval 1] [--runs 2]

Starts each package's pair of binaries on the CPU with the same config
(``aggregator.interval`` and ``monitor.interval`` both ``--interval``
seconds, aggregator pipeline depth 1, ratio attribution, the fake CPU
meter over this machine's /proc): ``kepler_tpu.cmd.aggregator`` and
``kepler_tpu.cmd.main`` with ``JAX_PLATFORMS=cpu``, and
``kepler_tpu_torch.cmd.aggregator`` and ``kepler_tpu_torch.cmd.main``
with ``--device cpu``. For each run it prints one JSON line: the node's
start-up seconds (spawn → ``/readyz``) and the seconds from the node's
readiness to the first ``/v1/results?node=…`` that holds it (polled
every 20 ms). Runs alternate between the packages (port, JAX, JAX, port,
…) so both see the same host load; the last line holds the medians.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"port": ("kepler_tpu_torch", ["--device", "cpu"]),
            "jax": ("kepler_tpu", [])}


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def get(url: str) -> bytes | None:
    try:
        with urllib.request.urlopen(url, timeout=5) as resp:
            return resp.read()
    except (urllib.error.URLError, OSError):
        return None


def wait_for(url: str, proc: subprocess.Popen, deadline_s: float) -> float:
    """Poll ``url`` until it answers 2xx → the perf_counter time it did."""
    end = time.perf_counter() + deadline_s
    while time.perf_counter() < end:
        if proc.poll() is not None:
            raise RuntimeError(f"{proc.args[2]} exited {proc.returncode}")
        if get(url) is not None:
            return time.perf_counter()
        time.sleep(0.02)
    raise TimeoutError(url)


def one_run(which: str, interval: float, tmp: str) -> dict:
    pkg, extra = PACKAGES[which]
    agg_port, node_port = free_port(), free_port()
    agg_cfg = os.path.join(tmp, "aggregator.yaml")
    node_cfg = os.path.join(tmp, "node.yaml")
    with open(agg_cfg, "w") as f:
        f.write(f"aggregator:\n  interval: {interval:g}s\n")
    with open(node_cfg, "w") as f:
        f.write("dev:\n  fake-cpu-meter:\n    enabled: true\n")
    env = dict(os.environ, PYTHONPATH=HERE, JAX_PLATFORMS="cpu")
    popen = dict(cwd=HERE, env=env, stdout=subprocess.DEVNULL,
                 stderr=subprocess.DEVNULL)
    agg = subprocess.Popen(
        [sys.executable, "-m", f"{pkg}.cmd.aggregator", *extra,
         "--config.file", agg_cfg, "--aggregator.model", "",
         "--aggregator.pipeline-depth", "1", "--no-exporter.prometheus",
         "--aggregator.listen-address", f"127.0.0.1:{agg_port}"], **popen)
    procs = [agg]
    try:
        wait_for(f"http://127.0.0.1:{agg_port}/readyz", agg, 120)
        t0 = time.perf_counter()
        node = subprocess.Popen(
            [sys.executable, "-m", f"{pkg}.cmd.main", *extra,
             "--config.file", node_cfg,
             "--monitor.interval", f"{interval:g}s",
             "--web.listen-address", f"127.0.0.1:{node_port}",
             "--kube.node-name", "first-result-node",
             "--aggregator.endpoint", f"127.0.0.1:{agg_port}"], **popen)
        procs.append(node)
        ready = wait_for(f"http://127.0.0.1:{node_port}/readyz", node, 120)
        first = wait_for(f"http://127.0.0.1:{agg_port}/v1/results"
                         "?node=first-result-node", agg, 60)
    finally:
        for proc in procs:
            proc.send_signal(signal.SIGTERM)
        for proc in procs:
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    return {"package": which, "interval_s": interval,
            "node_ready_s": ready - t0,
            "first_result_after_ready_s": first - ready}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--interval", type=float, default=1.0)
    p.add_argument("--runs", type=int, default=2,
                   help="runs per package")
    args = p.parse_args()
    order = [w for i in range(args.runs)
             for w in (("port", "jax") if i % 2 == 0 else ("jax", "port"))]
    rows = []
    tmp = tempfile.mkdtemp(prefix="kt-first-")
    try:
        for which in order:
            row = one_run(which, args.interval, tmp)
            rows.append(row)
            print(json.dumps(row), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"median_first_result_after_ready_s": {
        w: statistics.median(r["first_result_after_ready_s"]
                             for r in rows if r["package"] == w)
        for w in PACKAGES}, "median_node_ready_s": {
        w: statistics.median(r["node_ready_s"] for r in rows
                             if r["package"] == w) for w in PACKAGES}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
