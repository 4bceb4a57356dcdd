"""The port stands alone: importing ``kepler_tpu_torch`` loads no JAX.

``tests/conftest.py`` imports jax into every test process, so the fence
is checked in a fresh interpreter: importing every module of
``kepler_tpu_torch`` must leave ``jax`` and every ``kepler_tpu.*`` module
out of ``sys.modules``, and the entry points built with their default
device must raise when CUDA is absent instead of running on the CPU.
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
                if m == "jax" or m.startswith("jax.")
                or m == "kepler_tpu" or m.startswith("kepler_tpu."))
raised = {}
import torch
if not torch.cuda.is_available():
    from kepler_tpu_torch.fleet.window import (FusedWindowEngine,
                                               PackedWindowEngine)
    from kepler_tpu_torch.parallel.packed import (
        make_fused_window_program, make_packed_fleet_program)
    for label, build in [
            ("PackedWindowEngine", lambda: PackedWindowEngine()),
            ("FusedWindowEngine", lambda: FusedWindowEngine()),
            ("make_packed_fleet_program",
             lambda: make_packed_fleet_program(8, 2)),
            ("make_fused_window_program",
             lambda: make_fused_window_program(8, 2, backend="pallas"))]:
        try:
            build()
            raised[label] = None
        except RuntimeError as err:
            raised[label] = str(err)
print(json.dumps({"modules": names, "leaked": leaked, "raised": raised,
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
    assert out["leaked"] == []
    if not out["cuda"]:
        for label, msg in out["raised"].items():
            assert msg is not None and "CUDA is not available" in msg, label


def test_port_sources_name_no_jax_import():
    """No source file of the port imports jax or kepler_tpu, even lazily
    inside a function."""
    bad = []
    for path in PKG.rglob("*.py"):
        for n, line in enumerate(path.read_text().splitlines(), 1):
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1]
                if mod.split(".")[0] in ("jax", "jaxlib", "kepler_tpu"):
                    bad.append(f"{path.relative_to(REPO)}:{n}: {s}")
    assert bad == []
