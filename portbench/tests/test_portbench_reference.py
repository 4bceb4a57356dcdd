"""At small sizes on the CPU the plain reference agrees with the port on
both cells' entries: the ratio split, the features, the temporal
estimator, the MLP and its refit, and the whole fleet window.

Products round their operands to the same precision on both sides, so
the only differences are the order of f32 sums (and, rarely, a bf16
rounding that such a difference tips): the tolerances are 1e-5 of the
largest magnitude, and the ratio split, which has no sum, is bit-equal.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import fleetgen
from portbench.harness import max_rel_gap
from portbench.reference import adamw, attribution, fleet, mlp, temporal
from portbench.reference.precision import rounding

TOL = 1e-5


def _window(tiny, seed: int = 5) -> tuple[dict, fleetgen.Fleet, dict]:
    cell = tiny("temporal-window")
    f = fleetgen.Fleet.of(cell.config)
    gen = torch.Generator().manual_seed(seed)
    win = fleetgen.windows(f, cell.traffic, gen, torch.device("cpu"), 1,
                           history=True)
    return {k: v[0] for k, v in win.items()}, f, cell.config


def test_ratio_split_is_bit_equal_to_the_port(tiny):
    from kepler_tpu_torch.ops.attribution import attribute_fleet

    w, _, _ = _window(tiny)
    args = [w[k] for k in fleetgen.BATCH_KEYS[:-1]]
    got = attribute_fleet(*args)
    ref = attribution.ratio_split(*args)
    assert torch.equal(got.node.energy_uj, ref["energy_uj"])
    assert torch.equal(got.node.power_uw, ref["power_uw"])
    assert torch.equal(got.workloads.energy_uj, ref["wl_energy_uj"])
    assert torch.equal(got.workloads.power_uw, ref["wl_power_uw"])


def test_window_features_match_the_port(tiny):
    from kepler_tpu_torch.models.features import build_features

    w, _, _ = _window(tiny)
    got = build_features(w["cpu_deltas"], w["workload_valid"],
                         w["node_cpu_delta"], w["usage_ratio"], w["dt_s"])
    ref = attribution.window_features(w["cpu_deltas"], w["workload_valid"],
                                      w["node_cpu_delta"], w["usage_ratio"],
                                      w["dt_s"])
    assert torch.equal(got, ref)


def test_history_rows_match_the_node_history():
    """A tick's feature rows as ``monitor.history`` records them."""
    from kepler_tpu_torch.monitor.history import feature_rows
    from kepler_tpu_torch.resource.informer import FeatureBatch

    cpu = torch.tensor([0.5, 1.5, 2.0])
    node = cpu.sum()
    want = feature_rows(FeatureBatch(
        kinds=np.zeros(3, np.int8), ids=["a", "b", "c"],
        cpu_deltas=cpu.numpy(), node_cpu_delta=float(node),
        usage_ratio=0.25), dt_s=5.0)
    got = attribution.tick_features(cpu, node, torch.tensor(0.25), 5.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-7)


def test_temporal_watts_match_the_port(tiny):
    from kepler_tpu_torch.models.temporal import predict_temporal

    w, f, config = _window(tiny)
    gen = torch.Generator().manual_seed(3)
    params = fleetgen.temporal_params(config["estimator"], f.zones, gen,
                                      torch.device("cpu"))
    n, ww, t, nf = w["feat_hist"].shape
    got = predict_temporal(params, w["feat_hist"], w["workload_valid"],
                           w["t_valid"])
    ref = temporal.watts(params, w["feat_hist"].reshape(n * ww, t, nf),
                         w["t_valid"].reshape(n * ww, t),
                         w["workload_valid"].reshape(n * ww),
                         rounding("bfloat16")).reshape(n, ww, -1)
    assert float(ref.abs().max()) > 0
    assert max_rel_gap(got.numpy(), ref.numpy()) < TOL


def test_fleet_window_matches_the_port(tiny):
    from kepler_tpu_torch.parallel.aggregator_core import (
        make_temporal_fleet_program, run_fleet_attribution)
    from kepler_tpu_torch.parallel.fleet import FleetBatch

    w, f, config = _window(tiny)
    gen = torch.Generator().manual_seed(4)
    params = fleetgen.temporal_params(config["estimator"], f.zones, gen,
                                      torch.device("cpu"))
    host = fleetgen.to_host(w)
    batch = FleetBatch(node_names=[""] * f.n, n_nodes=f.nodes,
                       workload_counts=[f.pods] * f.n, workload_ids=[],
                       **{k: host[k] for k in fleetgen.BATCH_KEYS})
    program = make_temporal_fleet_program(device="cpu", backend="pallas")
    r = run_fleet_attribution(program, batch, params, host["feat_hist"],
                              host["t_valid"])
    got = fleet.published_of((r.node_power_uw, r.node_energy_uj,
                              r.workload_power_uw, r.workload_energy_uj))
    ref = fleet.temporal_window(params, host, torch.device("cpu"),
                                "bfloat16", block=3)
    model = host["mode"] == fleet.MODE_MODEL
    for name in fleet.PUBLISHED:
        g, r_ = got[name].numpy(), ref[name]
        assert np.array_equal(g[~model], r_[~model]), name
        assert max_rel_gap(g[model], r_[model]) < TOL, name


def _dump(tiny, seed: int = 6):
    cell = tiny("mlp-refit")
    gen = torch.Generator().manual_seed(seed)
    data = fleetgen.training_dump(cell.config, cell.traffic, gen,
                                  torch.device("cpu"))
    return data, cell


def test_mlp_forward_matches_the_port(tiny):
    from kepler_tpu_torch.models.mlp import predict_mlp

    data, _ = _dump(tiny)
    x = torch.from_numpy(data["cpu_deltas"])[..., None].expand(-1, -1, 7)
    valid = torch.from_numpy(data["workload_valid"])
    p = mlp.init(9, 4, 128, 7)
    gen = torch.Generator().manual_seed(1)
    p.update({k: torch.randn(p[k].shape, generator=gen) * 0.1
              for k in ("w2", "b2", "w_skip", "b0", "b1")})
    got = predict_mlp(p, x, valid, clamp=False)
    ref = torch.where(valid[..., None], mlp.forward(p, x,
                                                    rounding("bfloat16")), 0)
    assert max_rel_gap(got.numpy(), ref.numpy()) < TOL


def test_refit_matches_the_port(tiny, monkeypatch):
    """Three steps of ``cmd.train``'s job against the plain refit: the
    losses, and each leaf's change by the norm (AdamW's first steps move
    an element by about the learning rate whatever its gradient's size,
    so an element whose gradient is near zero may move either way on
    either side)."""
    import argparse

    from kepler_tpu_torch.cmd.train import build_trainer

    from portbench.drivers.refit import leaf_gap, norms

    data, cell = _dump(tiny)
    args = argparse.Namespace(model="mlp", lr=1e-2, seed=11)
    state, step_fn, inputs = build_trainer(args, data, torch.device("cpu"))
    losses = []
    for _ in range(3):
        state, loss = step_fn(state, *inputs)
        losses.append(float(loss))
    valid = torch.from_numpy(data["workload_valid"])
    feats = attribution.window_features(
        torch.from_numpy(data["cpu_deltas"]), valid,
        torch.from_numpy(data["node_cpu_delta"]),
        torch.from_numpy(data["usage_ratio"]),
        torch.from_numpy(data["dt_s"]))
    monkeypatch.setattr(mlp, "BLOCK_ROWS", 5)  # sums over several blocks
    ref = adamw.refit(mlp.loss_and_grad, mlp.init(11, 4, 128, 7),
                      (feats, valid, torch.from_numpy(data["target_watts"]),
                       torch.from_numpy(data["label_valid"])),
                      adamw.AdamW(lr=1e-2), 3, rounding("bfloat16"))
    np.testing.assert_allclose(losses, ref.losses, rtol=TOL)
    start = mlp.init(11, 4, 128, 7)
    change = {k: v.detach() - start[k] for k, v in state.params.items()}
    ref_change = {k: ref.end[k] - start[k] for k in start}
    assert leaf_gap(norms(change), norms(ref_change)) < 1e-4


def test_a_step_from_a_later_state_matches_the_port(tiny, monkeypatch):
    """One step of ``cmd.train``'s job after eight, against the plain
    step from the job's own params and AdamW moments: the loss and each
    leaf's change."""
    import argparse

    from kepler_tpu_torch.cmd.train import build_trainer

    from portbench.drivers.refit import Session, leaf_gap, norms

    data, _ = _dump(tiny)
    args = argparse.Namespace(model="mlp", lr=1e-2, seed=12)
    state, step_fn, inputs = build_trainer(args, data, torch.device("cpu"))
    for _ in range(8):
        state, _ = step_fn(state, *inputs)
    kept = [x.clone() for x in Session._sources(state)]
    keys = list(state.params)
    before = [{k: kept[3 * i + j] for i, k in enumerate(keys)}
              for j in range(3)]
    state, loss = step_fn(state, *inputs)
    valid = torch.from_numpy(data["workload_valid"])
    feats = attribution.window_features(
        torch.from_numpy(data["cpu_deltas"]), valid,
        torch.from_numpy(data["node_cpu_delta"]),
        torch.from_numpy(data["usage_ratio"]),
        torch.from_numpy(data["dt_s"]))
    monkeypatch.setattr(mlp, "BLOCK_ROWS", 5)
    inputs = (feats, valid, torch.from_numpy(data["target_watts"]),
              torch.from_numpy(data["label_valid"]))
    ref = adamw.step_from(mlp.loss_and_grad, *before, state.step, inputs,
                          adamw.AdamW(lr=1e-2), rounding("bfloat16"))
    assert state.step == 9
    np.testing.assert_allclose(float(loss), ref.loss, rtol=TOL)
    change = {k: v.detach() - before[0][k] for k, v in state.params.items()}
    ref_change = {k: ref.end[k] - before[0][k] for k in keys}
    assert leaf_gap(norms(change), norms(ref_change)) < 1e-4
