"""A refit cell of any estimator family is new files and new entries: the
dumps carry histories where the family is temporal, the refit driver
finds its plain refit by the configuration's ``model``, and the MLP's
dumps and readings are as they were before either.

The pinned digests and readings were taken on the CPU from the harness
before that change, at ``tiny_cell`` sizes.
"""

from __future__ import annotations

import argparse
import hashlib
import json

import numpy as np
import pytest
import torch

from portbench import fleetgen, spec
from portbench.harness import Spans

CPU = torch.device("cpu")

# sha256 (first 16 hex digits) of each array's bytes, dtype and shape
MLP_DUMPS = {
    6: {"cpu_deltas": "1ef557ee70a97e47", "workload_valid": "4da85159a004e69d",
        "node_cpu_delta": "ed42dc364a28c830",
        "usage_ratio": "6ff291c659929f04", "dt_s": "942dbb166c1e2dbe",
        "target_watts": "d00bd27246a523bf",
        "label_valid": "b4b7cd355c6aa20d"},
    2**31 + 7: {"cpu_deltas": "264d84f0447083b5",
                "workload_valid": "4da85159a004e69d",
                "node_cpu_delta": "3ce150a930942c2f",
                "usage_ratio": "e4597bc5d661325a", "dt_s": "942dbb166c1e2dbe",
                "target_watts": "29d7bc8ba9d19376",
                "label_valid": "b4b7cd355c6aa20d"},
}

# the tiny cell's readings after its checked steps and two window steps:
# the program's, then the control's
MLP_READINGS = {
    4: ({"loss_gap": 8.74959380010783e-08,
         "change_gap": 1.608714088885581e-08,
         "timed_change_gap": 2.4752491800724637e-08, "unmoved_leaves": 0.0},
        {"loss_gap": 0.001327914780120691,
         "change_gap": 0.0020820689162934104,
         "timed_change_gap": 0.0020253381612619983, "unmoved_leaves": 0.0}),
    2**31 + 7: ({"loss_gap": 0.0, "change_gap": 3.6532520202204995e-08,
                 "timed_change_gap": 1.9158029271792707e-08,
                 "unmoved_leaves": 0.0},
                {"loss_gap": 0.006092182381611375,
                 "change_gap": 0.004619605097404053,
                 "timed_change_gap": 0.0017983711250071138,
                 "unmoved_leaves": 0.0}),
}

FAMILIES = ("linear", "mlp", "moe", "deep", "temporal")  # cmd.train's
WITHOUT_REFERENCE = [f for f in FAMILIES if not (
    spec.HERE / "reference" / f"refit_{f}.py").is_file()]


def _digest(x: np.ndarray) -> str:
    raw = np.ascontiguousarray(x).tobytes()
    raw += str(x.dtype).encode() + str(x.shape).encode()
    return hashlib.sha256(raw).hexdigest()[:16]


def _temporal_config(tiny, tmp_path) -> dict:
    """The tiny temporal fleet as a refit's configuration, read back from
    a file of its own."""
    config = dict(tiny("temporal-window").config, dump_windows=3)
    path = tmp_path / "fleet-tiny-temporal.json"
    path.write_text(json.dumps(config))
    return json.loads(path.read_text())


@pytest.mark.parametrize("seed", sorted(MLP_DUMPS))
def test_mlp_dumps_are_as_before(tiny, seed):
    cell = tiny("mlp-refit")
    gen = torch.Generator().manual_seed(seed)
    data = fleetgen.training_dump(cell.config, cell.traffic, gen, CPU)
    assert data.pop("zone_names") == cell.config["zones"]
    assert {k: _digest(v) for k, v in data.items()} == MLP_DUMPS[seed]


def test_temporal_dumps_carry_the_rapl_rows_histories(tiny, tmp_path):
    """The histories are the fleet windows' own, cut to the RAPL rows as
    every other array is, and ``cmd.train``'s temporal job steps on
    them."""
    from kepler_tpu_torch.cmd.train import build_trainer

    config = _temporal_config(tiny, tmp_path)
    traffic = spec.cell("mlp-refit").traffic
    seed = 2**31 + 5
    data = fleetgen.training_dump(config, traffic,
                                  torch.Generator().manual_seed(seed), CPU)
    fleet = fleetgen.Fleet.of(config)
    win = fleetgen.windows(fleet, traffic,
                           torch.Generator().manual_seed(seed), CPU,
                           config["dump_windows"], history=True)
    rapl = np.zeros(fleet.n, bool)
    rapl[:fleet.nodes] = ~fleet.model_nodes()
    rows = config["dump_windows"] * int(rapl.sum())
    t = config["history_window"]
    assert data["feat_hist"].shape == (rows, fleet.w, t, 7)
    assert data["t_valid"].shape == (rows, fleet.w, t)
    for key in ("feat_hist", "t_valid", "cpu_deltas"):
        want = win[key][:, torch.from_numpy(rapl)].flatten(0, 1).numpy()
        assert np.array_equal(data[key], want), key
    assert data["t_valid"].any()

    args = argparse.Namespace(model="temporal", lr=1e-2, seed=seed)
    state, step_fn, inputs = build_trainer(args, data, CPU)
    before = {k: v.detach().clone() for k, v in state.params.items()}
    state, loss = step_fn(state, *inputs)
    assert state.step == 1 and torch.isfinite(loss)
    assert all(torch.isfinite(v).all() for v in state.params.values())
    assert any(not torch.equal(v, before[k])
               for k, v in state.params.items())


@pytest.mark.parametrize("family", WITHOUT_REFERENCE)
def test_a_family_without_a_plain_refit_stops_at_setup(tiny, tmp_path,
                                                        family):
    config = dict(_temporal_config(tiny, tmp_path), model=family)
    traffic = spec.cell("mlp-refit").traffic
    with pytest.raises(FileNotFoundError, match=f"refit_{family}.py"):
        spec.driver("refit").setup(config, traffic, 3, CPU, Spans(False))


@pytest.mark.parametrize("seed", sorted(MLP_READINGS))
def test_mlp_refit_readings_are_as_before(tiny, seed):
    cell = tiny("mlp-refit")
    session = spec.driver("refit").setup(cell.config, cell.traffic, seed,
                                         CPU, Spans(False))
    for _ in range(2):  # a window of two steps
        session.state, _ = session.step_fn(session.state, *session.inputs)
    program, control = MLP_READINGS[seed]
    assert session.program_readings() == program
    assert session.control_gaps() == control
