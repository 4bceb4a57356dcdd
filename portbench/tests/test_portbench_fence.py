"""Nothing the benchmark runs loads JAX, the JAX package or the old
benchmarks: top-level module names are compared whole, since
``kepler_tpu_torch`` begins with ``kepler_tpu``. The reference imports
nothing of the port either."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

from portbench import spec

PKG = spec.HERE
FENCED = {"jax", "jaxlib", "flax", "kepler_tpu", "benchmarks"}

PROBE = r"""
import importlib, json, pkgutil, sys, time
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[2])
import portbench
for info in pkgutil.walk_packages(portbench.__path__, "portbench."):
    if ".tests" not in info.name:
        importlib.import_module(info.name)
import torch
from conftest import tiny_cell
from portbench.run import run_cell
for name in ("temporal-window", "mlp-refit"):
    out, _ = run_cell(tiny_cell(name), 3, 0.1, False, torch.device("cpu"),
                      time.perf_counter())
    assert out["correct"], name
print(json.dumps(sorted(sys.modules)))
"""


def test_a_run_loads_nothing_fenced():
    env = {"PATH": "/usr/bin:/bin", "HOME": str(Path.home()),
           "USE_FLAX": "0"}
    done = subprocess.run(
        [sys.executable, "-c", PROBE, str(spec.ROOT), str(PKG / "tests")],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=spec.ROOT)
    assert done.returncode == 0, done.stderr[-3000:]
    loaded = json.loads(done.stdout.strip().splitlines()[-1])
    leaked = sorted(m for m in loaded if m.split(".")[0] in FENCED)
    assert not leaked
    assert "kepler_tpu_torch" in loaded  # the compare is by whole name


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_anything_fenced():
    for path in PKG.rglob("*.py"):
        assert not (_imports(path) & FENCED), path


def test_the_reference_imports_nothing_of_the_port():
    for path in (PKG / "reference").rglob("*.py"):
        assert _imports(path) <= {"__future__", "contextlib", "math",
                                  "typing", "numpy", "torch",
                                  "portbench"}, path
