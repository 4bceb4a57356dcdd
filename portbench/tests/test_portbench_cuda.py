"""On the card: each cell through ``run.py`` as the benchmark's runs call
it, a short window, traced and not, with ``correct`` true and the result
line in the shape the benchmark prints (checks last)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench import spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_on_the_card(cuda_device, name, trace):
    done = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed",
         str(2**31 + 11 + trace), "--seconds", "2", "--trace", str(trace)],
        capture_output=True, text=True, timeout=360, cwd=spec.ROOT)
    assert done.returncode == 0, done.stderr[-3000:]
    out = json.loads(done.stdout.strip().splitlines()[-1])
    assert list(out)[-1] == "checks"
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    cell = spec.cell(name)
    want = cell.per_layer if trace else cell.end_to_end
    assert set(out["metrics"]) == {m["name"] for m in want}
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        assert out["breakdown"]["device_ops"]
