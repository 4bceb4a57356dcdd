"""The port stands alone: importing ``kepler_tpu_torch`` loads no JAX.

``tests/conftest.py`` imports jax into every test process, so the fence
is checked in a fresh interpreter: importing every module of
``kepler_tpu_torch`` must leave ``jax`` and every ``kepler_tpu.*`` module
out of ``sys.modules`` (and optax and orbax, the JAX package's training
libraries), and the entry points built with their default device must
raise when CUDA is absent instead of running on the CPU — meshes
(all visible devices, or virtual shards of ``cuda``) included, so no
shard is ever placed on the CPU unasked — and the aggregator, node,
training, chaos and analysis binaries' ``main`` return 1 and name CUDA
(the analysis binary for its device tier, which runs on the CPU only
with ``--device cpu``).
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "kepler_tpu_torch"

PROBE = r"""
import importlib, json, pkgutil, sys
import kepler_tpu_torch
names = []
for info in pkgutil.walk_packages(kepler_tpu_torch.__path__,
                                  "kepler_tpu_torch."):
    importlib.import_module(info.name)
    names.append(info.name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "optax", "orbax",
                                       "kepler_tpu"))
raised = {}
cmd_main = node_main = train_main = chaos_main = analysis_main = None
import torch
if not torch.cuda.is_available():
    import contextlib, io
    from kepler_tpu_torch.cmd import aggregator as cmd
    from kepler_tpu_torch.cmd import main as node_cmd
    from kepler_tpu_torch.device import FakeCPUMeter
    from kepler_tpu_torch.monitor import PowerMonitor, TerminatedTracker
    from kepler_tpu_torch.ops.topk import top_k_by_energy
    from kepler_tpu_torch.resource import ResourceInformer
    from kepler_tpu_torch.fleet.aggregator import Aggregator
    from kepler_tpu_torch.chaos import ChaosConfig, ChaosFleet, Trace
    from kepler_tpu_torch.chaos.__main__ import main as chaos_cmd
    from kepler_tpu_torch.server.http import APIServer
    from kepler_tpu_torch.fleet.window import (FusedWindowEngine,
                                               PackedWindowEngine)
    from kepler_tpu_torch.parallel.aggregator_core import (
        make_fleet_program, make_temporal_fleet_program)
    from kepler_tpu_torch.parallel.packed import (
        make_fused_window_program, make_packed_fleet_program)
    from kepler_tpu_torch.parallel.mesh import make_mesh
    from kepler_tpu_torch.parallel.sequence import make_temporal_program
    from kepler_tpu_torch.analysis.device import DEVICE_PROGRAMS
    from kepler_tpu_torch.analysis.device.trace import trace_case
    for label, build in [
            ("make_mesh", lambda: make_mesh()),
            ("make_mesh_virtual",
             lambda: make_mesh([8], devices=["cuda"] * 8)),
            ("PackedWindowEngine", lambda: PackedWindowEngine()),
            ("FusedWindowEngine", lambda: FusedWindowEngine()),
            ("make_packed_fleet_program",
             lambda: make_packed_fleet_program(8, 2)),
            ("make_fused_window_program",
             lambda: make_fused_window_program(8, 2, backend="pallas")),
            ("make_fleet_program", lambda: make_fleet_program()),
            ("make_temporal_program",
             lambda: make_temporal_program(make_mesh([8], ["seq"]))),
            ("make_temporal_fleet_program",
             lambda: make_temporal_fleet_program(backend="pallas")),
            ("Aggregator", lambda: Aggregator(APIServer()).init()),
            ("ChaosFleet", lambda: ChaosFleet(ChaosConfig(), Trace())),
            ("PowerMonitor",
             lambda: PowerMonitor(FakeCPUMeter(), ResourceInformer())),
            ("TerminatedTracker", lambda: TerminatedTracker(4, 0)),
            ("top_k_by_energy", lambda: top_k_by_energy([1.0, 2.0], 1)),
            ("trace_case", lambda: trace_case(
                DEVICE_PROGRAMS[0], DEVICE_PROGRAMS[0].cases[0]))]:
        try:
            build()
            raised[label] = None
        except RuntimeError as err:
            raised[label] = str(err)
    log = io.StringIO()
    with contextlib.redirect_stdout(log), contextlib.redirect_stderr(log):
        rc = cmd.main(["--no-exporter.prometheus"])
    cmd_main = {"rc": rc, "log": log.getvalue()}
    log = io.StringIO()
    with contextlib.redirect_stdout(log), contextlib.redirect_stderr(log):
        rc = node_cmd.main(["--no-exporter.prometheus"])
    node_main = {"rc": rc, "log": log.getvalue()}
    import logging
    from kepler_tpu_torch.cmd import train as train_cmd
    log = io.StringIO()
    handler = logging.StreamHandler(log)
    logging.getLogger("kepler.train").addHandler(handler)
    rc = train_cmd.main(["--data", "no-such-dir", "--out", "p.npz"])
    train_main = {"rc": rc, "log": log.getvalue()}
    log = io.StringIO()
    with contextlib.redirect_stdout(log), contextlib.redirect_stderr(log):
        rc = chaos_cmd(["--schedule", "0"])
    chaos_main = {"rc": rc, "log": log.getvalue()}
    from kepler_tpu_torch.analysis.__main__ import main as lint_cmd
    log = io.StringIO()
    with contextlib.redirect_stdout(log), contextlib.redirect_stderr(log):
        rc = lint_cmd(["--device-tier", "kepler_tpu_torch/ops/deltas.py"])
        rc_snap = lint_cmd(["--update-snapshots"])
    analysis_main = {"rc": max(rc, rc_snap), "log": log.getvalue()}
print(json.dumps({"modules": names, "leaked": leaked, "raised": raised,
                  "cmd_main": cmd_main, "node_main": node_main,
                  "train_main": train_main, "chaos_main": chaos_main,
                  "analysis_main": analysis_main,
                  "cuda": torch.cuda.is_available()}))
"""


def run_probe() -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=120, check=False)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_port_imports_no_jax_and_defaults_raise_without_cuda():
    out = run_probe()
    # every module of the package was imported
    expected = {".".join(("kepler_tpu_torch",) + p.relative_to(PKG)
                         .with_suffix("").parts)
                for p in PKG.rglob("*.py") if p.name != "__init__.py"}
    assert expected <= set(out["modules"])
    # the slice-7 packages are among them, their entry points included,
    # and the parallel families
    for mod in ("chaos.conductor", "chaos.harness", "chaos.__main__",
                "blackbox", "blackbox.__main__", "parallel.mesh",
                "parallel.collectives", "parallel.ring", "parallel.sequence",
                "parallel.ulysses", "parallel.pipeline", "parallel.expert",
                "parallel.trainer", "analysis.__main__", "analysis.engine",
                "analysis.project", "analysis.rules.donate",
                "analysis.protocol.models", "analysis.device.registry",
                "analysis.device.trace", "ops.recorder"):
        assert f"kepler_tpu_torch.{mod}" in out["modules"], mod
    assert out["leaked"] == []
    if not out["cuda"]:
        assert len(out["raised"]) == 15
        for label, msg in out["raised"].items():
            assert msg is not None and "CUDA is not available" in msg, label
        for binary in ("cmd_main", "node_main", "train_main", "chaos_main",
                       "analysis_main"):
            assert out[binary]["rc"] == 1, binary
            assert "CUDA is not available" in out[binary]["log"], binary


def test_port_sources_name_no_jax_import():
    """No source file of the port imports jax or kepler_tpu, even lazily
    inside a function."""
    bad = []
    for path in PKG.rglob("*.py"):
        for n, line in enumerate(path.read_text().splitlines(), 1):
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1]
                if mod.split(".")[0] in ("jax", "jaxlib", "optax", "orbax",
                                         "kepler_tpu"):
                    bad.append(f"{path.relative_to(REPO)}:{n}: {s}")
    assert bad == []
