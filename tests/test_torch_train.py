"""The port's training, checkpoints and ``cmd.train`` against the JAX
package's.

Seeded numpy inputs at a small size (moe E = 3, H = 16; deep S = 2, D =
16; temporal d = 16, T = 8) with pad rows, invalid workloads and a zone
with no labels. Tolerances:

- ``masked_mse``, ``masked_relative_mse``: rtol 1e-6;
- ``warm_start_wide`` / ``warm_start_moe`` (an SVD either side): rtol
  1e-4;
- loss and gradients of all five families at f32 compute against
  ``jax.value_and_grad``: rtol 1e-5 (atol 1e-5 · max|grad| per leaf);
- ``torch.optim.AdamW`` against ``optax.adamw`` over five steps of the
  same gradients: rtol 1e-5, atol 1e-6 (measured 4e-6: the decay and
  the moment ratio are applied in another order of f32 operations);
- ten whole train steps at f32 compute: every step's loss within rtol
  1e-4 (measured worst 2.1e-5). Adam's first steps are nearly ``lr · sign(g)``, so a gradient
  component near zero can flip a parameter by up to ``2 · lr`` between
  the packages; the losses, not the parameters, are held;
- ten steps of the default bf16 trunks (mlp, moe, deep, temporal): the
  loss trajectory within rtol 1e-2 of JAX's (measured worst 1.3e-3,
  deep and temporal). JAX's transpose of an f32-accumulating bf16 product
  does not round the cotangents where autograd does.
"""

from __future__ import annotations

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kepler_tpu.cmd import train as jcmd
from kepler_tpu.models import estimator as jest
from kepler_tpu.models import train as jtrain
from kepler_tpu.models.temporal import predict_temporal as jpredict_temporal
from kepler_tpu_torch.cmd import train as pcmd
from kepler_tpu_torch.fleet import wire
from kepler_tpu_torch.fleet.aggregator import Aggregator as PAggregator
from kepler_tpu_torch.models import estimator as port_est
from kepler_tpu_torch.models import train as ptrain
from kepler_tpu_torch.models.checkpoint import TrainCheckpointer
from kepler_tpu_torch.models.temporal import predict_temporal
from kepler_tpu_torch.parallel.fleet import MODE_RATIO, NodeReport
from kepler_tpu_torch.server.http import APIServer as PServer
from tests.test_torch_models import deep_params, inputs, moe_params, t
from tests.test_torch_temporal import jax_params as temporal_params

Z = 4
FAMILIES = ("linear", "mlp", "moe", "deep", "temporal")


def labels(seed: int, n: int = 5, w: int = 9):
    """(features, valid, targets, label_valid) with a zone (2) that no
    row labels."""
    feats, valid = inputs(seed, n, w)
    rng = np.random.default_rng(seed + 50)
    targets = rng.uniform(0.0, 3.0, (n, w, Z)).astype(np.float32)
    lv = rng.random((n, w, Z)) > 0.2
    lv[..., 2] = False
    return feats, valid, targets, lv


def history(seed: int, n: int = 5, w: int = 9, t_len: int = 8):
    """feat_hist [n, w, T, F] and right-padded t_valid [n, w, T]."""
    rng = np.random.default_rng(seed)
    hist = rng.normal(0.0, 1.0, (n, w, t_len, 7)).astype(np.float32)
    lengths = rng.integers(0, t_len + 1, (n, w))
    tv = np.arange(t_len)[None, None, :] < lengths[..., None]
    return np.where(tv[..., None], hist, 0.0).astype(np.float32), tv


def family_params(family: str) -> dict:
    """JAX-shaped numpy params with non-zero output layers."""
    if family == "moe":
        return moe_params(21)
    if family == "deep":
        return deep_params(22)
    if family == "temporal":
        return temporal_params(z=Z, d_model=16, t_max=8, seed=23)
    rng = np.random.default_rng(24)
    if family == "linear":
        return {"weight": rng.normal(0, 0.3, (7, Z)).astype(np.float32),
                "bias": rng.normal(0, 0.1, Z).astype(np.float32)}
    from kepler_tpu.models.mlp import init_mlp

    p = {k: np.asarray(v) for k, v in
         init_mlp(jax.random.PRNGKey(24), Z, hidden=16).items()}
    p["w2"] = rng.normal(0, 0.3, p["w2"].shape).astype(np.float32)
    p["w_skip"] = rng.normal(0, 0.2, p["w_skip"].shape).astype(np.float32)
    return p


def predictors(family: str, cd: str | None):
    """(JAX predict, port predict) over (params, *inputs, valid) at
    compute dtype ``cd`` (None: each function's default)."""
    jkw = {} if cd is None or family == "linear" else {
        "compute_dtype": jnp.float32}
    pkw = {} if cd is None or family == "linear" else {
        "compute_dtype": torch.float32}
    if family == "temporal":
        return (functools.partial(jpredict_temporal, **jkw),
                functools.partial(predict_temporal, **pkw))
    return (functools.partial(jest.predictor(family), **jkw),
            functools.partial(port_est.predictor(family), **pkw))


def family_inputs(family: str, seed: int):
    feats, valid, targets, lv = labels(seed)
    if family == "temporal":
        hist, tv = history(seed + 1)
        valid = valid & tv.any(-1)
        return (hist, valid, tv), targets, lv
    return (feats, valid), targets, lv


def jtree(p):
    return jax.tree.map(jnp.asarray, p)


# -- losses and warm starts ------------------------------------------------------------

@pytest.mark.parametrize("with_labels", [False, True])
def test_masked_losses_match_jax(with_labels):
    feats, valid, targets, lv = labels(1)
    pred = np.random.default_rng(2).normal(1.0, 1.0, targets.shape).astype(
        np.float32)
    lv_j, lv_p = ((jnp.asarray(lv), t(lv)) if with_labels
                  else (None, None))
    for jfn, pfn in ((jtrain.masked_mse, ptrain.masked_mse),
                     (jtrain.masked_relative_mse,
                      ptrain.masked_relative_mse)):
        want = float(jfn(jnp.asarray(pred), jnp.asarray(targets),
                         jnp.asarray(valid), lv_j))
        got = pfn(t(pred), t(targets), t(valid), lv_p)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6)
    # nothing valid: the count floors at 1, the loss is 0
    none = np.zeros_like(valid)
    assert float(ptrain.masked_mse(t(pred), t(targets), t(none))) == 0.0


def test_warm_starts_match_jax():
    feats, valid, targets, lv = labels(3, n=6, w=12)
    mlp = family_params("mlp")
    want = jtrain.warm_start_wide(jtree(mlp), jnp.asarray(feats),
                                  jnp.asarray(valid), jnp.asarray(targets),
                                  jnp.asarray(lv))
    got = ptrain.warm_start_wide(port_est.params_from_numpy("mlp", mlp),
                                 t(feats), t(valid), t(targets), t(lv))
    w_want = np.asarray(want["w_skip"])
    np.testing.assert_allclose(got["w_skip"].numpy(), w_want, rtol=1e-4,
                               atol=1e-4 * np.abs(w_want).max())
    assert torch.equal(got["w0"], t(mlp["w0"]))
    moe = family_params("moe")
    expert_id = np.array([0, 1, 2, 0, 1, 2], np.int32)
    want = jtrain.warm_start_moe(jtree(moe), jnp.asarray(feats),
                                 jnp.asarray(valid), jnp.asarray(targets),
                                 jnp.asarray(expert_id))
    got = ptrain.warm_start_moe(port_est.params_from_numpy("moe", moe),
                                t(feats), t(valid), t(targets),
                                t(expert_id))
    w_want = np.asarray(want["w_skip"])
    assert got["w_skip"].shape == (3, 7, Z)
    np.testing.assert_allclose(got["w_skip"].numpy(), w_want, rtol=1e-4,
                               atol=1e-4 * np.abs(w_want).max())


# -- loss and gradients ------------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_loss_and_gradients_match_jax_at_f32(family):
    params = family_params(family)
    args, targets, lv = family_inputs(family, 4)
    jpred, ppred = predictors(family, "f32")

    def jloss(p):
        pred = jpred(p, *(jnp.asarray(a) for a in args), clamp=False)
        return jtrain.masked_mse(pred, jnp.asarray(targets),
                                 jnp.asarray(args[-2 if family == "temporal"
                                                  else 1]),
                                 jnp.asarray(lv))

    want_loss, want_grads = jax.value_and_grad(jloss)(jtree(params))
    state = ptrain.create_train_state(
        port_est.params_from_numpy(family, params), ptrain.make_optimizer())
    valid = t(args[-2 if family == "temporal" else 1])
    pred = ppred(state.params, *(t(a) for a in args), clamp=False)
    loss = ptrain.masked_mse(pred, t(targets), valid, t(lv))
    leaves = ptrain.param_leaves(state.params)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    want_leaves = ptrain.param_leaves(jax.tree.map(np.asarray, want_grads))
    assert len(want_leaves) == len(grads)
    for g, w in zip(grads, want_leaves):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-6))


def test_adamw_matches_optax_over_five_steps():
    rng = np.random.default_rng(5)
    params = {"a": rng.normal(size=(7, 4)).astype(np.float32),
              "blocks": {"b": rng.normal(size=(3,)).astype(np.float32)}}
    grads = [jax.tree.map(lambda v: (rng.normal(size=v.shape) * 10.0 ** (
        rng.integers(-3, 2))).astype(np.float32), params) for _ in range(5)]
    opt = optax.adamw(3e-2, weight_decay=1e-2)
    jp = jtree(params)
    st = opt.init(jp)
    state = ptrain.create_train_state(
        port_est.params_to(params, "cpu"), ptrain.make_optimizer(3e-2, 1e-2))
    leaves = ptrain.param_leaves(state.params)
    for g in grads:
        upd, st = opt.update(jtree(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        for leaf, gl in zip(leaves, ptrain.param_leaves(g)):
            leaf.grad = torch.from_numpy(gl)
        state.opt_state.step()
    for got, want in zip(leaves, ptrain.param_leaves(
            jax.tree.map(np.asarray, jp))):
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-6)


# -- whole train steps ---------------------------------------------------------------------

def trajectories(family: str, cd: str | None, steps: int = 10):
    """Per-step losses of ``steps`` AdamW steps in each package."""
    params = family_params(family)
    args, targets, lv = family_inputs(family, 6)
    jpred, ppred = predictors(family, cd)
    opt = jtrain.make_optimizer(1e-2)
    if family == "temporal":
        jstep = jax.jit(jtrain.temporal_step_fn(
            opt, None if cd is None else jnp.float32))
        pstep = ptrain.make_temporal_train_step(
            None if cd is None else torch.float32)
    else:
        jstep = jtrain.make_train_step(jpred, opt)
        pstep = ptrain.make_train_step(ppred)
    jstate = jtrain.create_train_state(jtree(params), opt)
    pstate = ptrain.create_train_state(
        port_est.params_from_numpy(family, params),
        ptrain.make_optimizer(1e-2))
    jl, pl = [], []
    for _ in range(steps):
        jstate, loss = jstep(jstate, *(jnp.asarray(a) for a in args),
                             jnp.asarray(targets), jnp.asarray(lv))
        jl.append(float(loss))
        pstate, loss = pstep(pstate, *(t(a) for a in args), t(targets),
                             t(lv))
        pl.append(float(loss))
    assert pstate.step == int(jstate.step) == steps
    return np.asarray(pl), np.asarray(jl)


@pytest.mark.parametrize("family", FAMILIES)
def test_ten_train_steps_match_jax(family):
    got, want = trajectories(family, "f32")
    assert got[-1] < got[0]  # the loss falls
    np.testing.assert_allclose(got, want, rtol=1e-4)
    if family != "linear":  # the default compute: bf16 trunks
        got, want = trajectories(family, None)
        assert got[-1] < got[0]
        np.testing.assert_allclose(got, want, rtol=1e-2)


def test_fit_and_remat_step():
    params = family_params("mlp")
    (feats, valid), targets, _ = family_inputs("mlp", 7)
    fitted, loss = ptrain.fit(port_est.predictor("mlp"),
                              port_est.params_from_numpy("mlp", params),
                              t(feats), t(valid), t(targets), steps=20)
    _, jloss = jtrain.fit(jest.predictor("mlp"), jtree(params),
                          jnp.asarray(feats), jnp.asarray(valid),
                          jnp.asarray(targets), steps=20)
    assert not any(v.requires_grad for v in fitted.values())
    np.testing.assert_allclose(loss, jloss, rtol=1e-2)
    # remat recomputes the forward in the backward: the same step
    (hist, valid, tv), targets, lv = family_inputs("temporal", 8)
    tp = port_est.params_from_numpy("temporal", family_params("temporal"))
    out = []
    for remat in (False, True):
        step = ptrain.make_temporal_train_step(compute_dtype=torch.float32,
                                               remat=remat)
        state = ptrain.create_train_state(tp, ptrain.make_optimizer())
        state, loss = step(state, t(hist), t(valid), t(tv), t(targets))
        out.append((float(loss), ptrain.param_leaves(state.params)))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


# -- the step's telemetry spans --------------------------------------------------------------

# the program's spans, then torch's own range of AdamW's step, which
# ``optimizer_device_ms`` reads
STEP_STAGES = ("train.forward", "train.loss", "train.backward",
               "Optimizer.step#AdamW.step")


def spanned_step(case: str, tmp_path=None):
    """One step of ``make_train_step`` (mlp) or ``make_temporal_train_step``
    (with or without remat) → (loss, params after it, the step's
    ``train.*`` and AdamW profiler ranges: None untraced)."""
    from torch.profiler import ProfilerActivity, profile

    family = "mlp" if case == "mlp" else "temporal"
    args, targets, lv = family_inputs(family, 9)
    if case == "mlp":
        step = ptrain.make_train_step(port_est.predictor("mlp"))
    else:
        step = ptrain.make_temporal_train_step(
            compute_dtype=torch.float32, remat=case == "temporal-remat")
    state = ptrain.create_train_state(
        port_est.params_from_numpy(family, family_params(family)),
        ptrain.make_optimizer(1e-2))
    inputs = [t(a) for a in args] + [t(targets), t(lv)]
    if tmp_path is None:
        state, loss = step(state, *inputs)
        return loss, ptrain.param_leaves(state.params), None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, loss = step(state, *inputs)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"
              and (e["name"].startswith("train.")
                   or e["name"] == STEP_STAGES[-1])]
    return loss, ptrain.param_leaves(state.params), events


@pytest.mark.parametrize("case", ["mlp", "temporal", "temporal-remat"])
def test_a_profiled_step_shows_its_stages_and_is_bit_equal(tmp_path, case):
    loss, leaves, events = spanned_step(case, tmp_path)
    names = [e["name"] for e in events]
    assert sorted(names) == sorted(("train.step",) + STEP_STAGES)
    by = {e["name"]: e for e in events}
    outer = by["train.step"]
    end = outer["ts"]
    for name in STEP_STAGES:  # inside the step, in this order, disjoint
        e = by[name]
        assert end <= e["ts"]
        end = e["ts"] + e["dur"]
        assert end <= outer["ts"] + outer["dur"]
    plain_loss, plain_leaves, _ = spanned_step(case)
    assert torch.equal(loss, plain_loss)
    for a, b in zip(leaves, plain_leaves):
        assert torch.equal(a, b)


# -- models.checkpoint ----------------------------------------------------------------------

def mlp_run(steps: int, ck: TrainCheckpointer | None = None,
            every: int = 0, resume: bool = False):
    (feats, valid), targets, lv = family_inputs("mlp", 9)
    state = ptrain.create_train_state(
        port_est.params_from_numpy("mlp", family_params("mlp")),
        ptrain.make_optimizer(1e-2))
    if resume:
        state = ck.restore_latest(state)
    step = ptrain.make_train_step(port_est.predictor("mlp"))
    while state.step < steps:
        state, _ = step(state, t(feats), t(valid), t(targets), t(lv))
        if ck is not None and every and state.step % every == 0:
            ck.save(state)
    return state


def test_checkpoint_round_trip_and_resume(tmp_path):
    straight = mlp_run(8)
    with TrainCheckpointer(str(tmp_path / "ck")) as ck:
        assert ck.latest_step() is None
        assert ck.restore_latest(mlp_run(0)) is None
        mlp_run(4, ck, every=2)
        assert ck.latest_step() == 4
        assert ck.save(mlp_run(4)) is False  # step 4 exists
        back = ck.restore_latest(mlp_run(0))
        assert back.step == 4
        assert back.opt_state.state_dict()["state"][0]["step"] == 4
        resumed = mlp_run(8, ck, resume=True)
        ck.wait()
    assert resumed.step == straight.step == 8
    for a, b in zip(ptrain.param_leaves(resumed.params),
                    ptrain.param_leaves(straight.params)):
        assert torch.equal(a, b)


def test_checkpoint_max_to_keep_and_stale_temporary(tmp_path):
    d = tmp_path / "ck"
    ck = TrainCheckpointer(str(d), max_to_keep=2)
    mlp_run(5, ck, every=1)
    assert sorted(os.listdir(d)) == ["4.pt", "5.pt"]
    # a save cut short leaves its temporary file: never a checkpoint
    (d / "9.pt.tmp-123").write_bytes(b"torn")
    (d / "notes.txt").write_text("x")
    assert ck.latest_step() == 5
    assert ck.restore_latest(mlp_run(0)).step == 5
    wrong = ptrain.create_train_state(
        port_est.params_from_numpy("linear", family_params("linear")),
        ptrain.make_optimizer())
    with pytest.raises(ValueError, match="other shapes"):
        ck.restore_latest(wrong)
    keep_all = TrainCheckpointer(str(tmp_path / "all"), max_to_keep=None)
    mlp_run(4, keep_all, every=1)
    assert keep_all.latest_step() == 4 and len(
        os.listdir(tmp_path / "all")) == 4


# -- cmd.train ---------------------------------------------------------------------------

def dump_windows(root, model_mode=None, n_windows: int = 3, seed: int = 0,
                 history_window: int = 4) -> str:
    """Training dumps written by the port's Aggregator on the CPU: two
    RAPL nodes × 4 workloads, zones package and dram."""
    d = str(root / "dump")
    agg = PAggregator(PServer(), device="cpu", model_mode=model_mode,
                      training_dump_dir=d, node_bucket=8, workload_bucket=8,
                      history_window=history_window)
    rng = np.random.default_rng(seed)

    class Req:
        command = "POST"

    for seq in range(1, n_windows + 1):
        for n in range(2):
            cpu = rng.uniform(0.5, 4.0, 4).astype(np.float32)
            req = Req()
            req.body = wire.encode_report(NodeReport(
                node_name=f"metal-{n}",
                zone_deltas_uj=rng.uniform(1e7, 1e8, 2).astype(np.float32),
                zone_valid=np.ones(2, bool), usage_ratio=0.6,
                cpu_deltas=cpu, workload_ids=[f"m{n}-w{i}" for i in range(4)],
                node_cpu_delta=float(cpu.sum()), dt_s=5.0, mode=MODE_RATIO),
                ["package", "dram"], seq=seq)
            assert agg._handle_report(req)[0] == 204
        agg.aggregate_once()
    return d


def write_window(d, name, zones, zone_valid, watts, w=4, cpu=None,
                 workload_valid=None):
    """One RAPL node's dump: ``w`` slots, every one a workload with 1 CPU
    unit unless ``cpu`` and ``workload_valid`` say otherwise."""
    np.savez_compressed(
        d / name, zone_names=np.asarray(zones),
        zone_valid=np.asarray(zone_valid, bool).reshape(1, -1),
        cpu_deltas=(np.ones((1, w), np.float32) if cpu is None
                    else np.asarray(cpu, np.float32).reshape(1, w)),
        workload_valid=(np.ones((1, w), bool) if workload_valid is None
                        else np.asarray(workload_valid, bool).reshape(1, w)),
        node_cpu_delta=np.full(1, 4.0, np.float32),
        usage_ratio=np.full(1, 0.5, np.float32),
        dt_s=np.full(1, 5.0, np.float32),
        target_watts=np.asarray(watts, np.float32).reshape(1, w, -1))


@pytest.mark.parametrize("case", ["mixed_zone_files", "node_missing_zone",
                                  "temporal_dumps"])
def test_load_windows_aligns_zones_as_jax(tmp_path, case):
    d = tmp_path / "dump"
    d.mkdir()
    if case == "mixed_zone_files":
        write_window(d, "window-1-000001.npz", ["core", "package"],
                     [True, True], np.stack([np.full((1, 4), 1.0),
                                             np.full((1, 4), 2.0)], -1))
        write_window(d, "window-2-000002.npz", ["dram", "package"],
                     [True, True], np.stack([np.full((1, 4), 3.0),
                                             np.full((1, 4), 4.0)], -1))
    elif case == "node_missing_zone":
        write_window(d, "window-1-000001.npz", ["dram", "package"],
                     [False, True], np.zeros((1, 4, 2)))
    else:
        d = dump_windows(tmp_path / "t", model_mode="temporal")
    got, files = pcmd.load_windows(str(d))
    want, jfiles = jcmd.load_windows(str(d))
    assert files == jfiles and sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
    if case == "mixed_zone_files":
        assert got["zone_names"] == ["core", "dram", "package"]
        lv = got["label_valid"]
        assert lv[0, :, 0].all() and not lv[0, :, 1].any()
        assert lv[1, :, 1].all() and not lv[1, :, 0].any()
    elif case == "node_missing_zone":
        assert not got["label_valid"][0, :, 0].any()
    else:
        assert got["feat_hist"].shape[2] == 4
    with pytest.raises(FileNotFoundError, match="window-"):
        pcmd.load_windows(str(tmp_path / "nowhere"))


REFIT_DUMPS = ("padded_slots", "node_missing_zone", "every_slot_valid")


def refit_dump(root, dump: str, seed: int = 3) -> str:
    """Eight one-node windows, zones dram and package: ``padded_slots``
    holds 3-8 slots a file, a random share of them workloads, padded to 8
    by ``load_windows``; ``node_missing_zone`` fills all 8 slots, with
    nodes that lack dram, package or both; ``every_slot_valid`` fills all
    8 slots with every zone read."""
    d = root / "refit"
    d.mkdir()
    rng = np.random.default_rng(seed)
    missing = ([False, True], [True, False], [False, False], [True, True])
    for i in range(8):
        w = int(rng.integers(3, 9)) if dump == "padded_slots" else 8
        wvalid = (rng.random(w) < 0.6 if dump == "padded_slots"
                  else np.ones(w, bool))
        zv = missing[i % 4] if dump == "node_missing_zone" else [True, True]
        write_window(d, f"window-{i}-{i + 1:06d}.npz", ["dram", "package"],
                     zv, rng.uniform(0.0, 5.0, (w, 2)), w=w,
                     cpu=rng.uniform(0.1, 4.0, w), workload_valid=wvalid)
    return str(d)


def padded_inputs(data: dict) -> tuple[torch.Tensor, ...]:
    """``cmd.train``'s inputs before the gather: every slot of the dumps,
    ``[B, W, ...]``."""
    from kepler_tpu_torch.models import build_features

    valid = torch.from_numpy(data["workload_valid"])
    feats = build_features(
        torch.from_numpy(data["cpu_deltas"]), valid,
        torch.from_numpy(data["node_cpu_delta"]),
        torch.from_numpy(data["usage_ratio"]),
        torch.from_numpy(data["dt_s"]))
    return (feats, valid, torch.from_numpy(data["target_watts"]),
            torch.from_numpy(data["label_valid"]))


def assert_steps_as_padded(state, step_fn, inputs, params, lr, ref_step,
                           padded) -> None:
    """Three steps of ``step_fn`` on ``inputs`` are three steps of
    ``ref_step`` on every padded slot from ``params``, the state's own
    start: the losses within rtol 1e-5, each leaf's change by the norm
    within 1e-5 of the larger of that leaf's change and the median
    leaf's (AdamW's first steps may move an element with a near-zero
    gradient either way)."""
    start = [v.detach().clone() for v in ptrain.param_leaves(state.params)]
    ref = ptrain.create_train_state(params, ptrain.make_optimizer(lr))
    assert all(torch.equal(v, s)
               for v, s in zip(ptrain.param_leaves(ref.params), start))
    losses, ref_losses = [], []
    for _ in range(3):
        state, loss = step_fn(state, *inputs)
        ref, ref_loss = ref_step(ref, *padded)
        losses.append(float(loss))
        ref_losses.append(float(ref_loss))
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)

    got, want = ([float(torch.linalg.vector_norm((v.detach() - s).double()))
                  for v, s in zip(ptrain.param_leaves(st.params), start)]
                 for st in (state, ref))
    median = float(np.median(want))
    assert median > 0
    for i, (a, b) in enumerate(zip(got, want)):
        assert abs(a - b) <= 1e-5 * max(b, median), i


@pytest.mark.parametrize("dump", REFIT_DUMPS)
@pytest.mark.parametrize("family", ("linear", "mlp", "moe", "deep"))
def test_build_trainer_steps_on_labelled_rows_as_the_padded_step(
        tmp_path, family, dump):
    """``build_trainer``'s inputs are the labelled rows of the dumps, in
    dump order, and three of its steps are three steps of
    ``make_train_step`` on every slot from the same seed
    (``assert_steps_as_padded``)."""
    data, _ = pcmd.load_windows(refit_dump(tmp_path, dump))
    args = pcmd.parse_args(["--data", ".", "--out", "p.npz", "--model",
                            family, "--seed", "5", "--device", "cpu"])
    state, step_fn, inputs = pcmd.build_trainer(args, data,
                                                torch.device("cpu"))
    padded = padded_inputs(data)
    keep = padded[3].any(-1)
    rows = int(keep.sum())
    if dump == "every_slot_valid":
        assert rows == keep.numel()
    else:
        assert 0 < rows < keep.numel()
    feats, valid, targets, lv = inputs
    assert feats.shape == (rows, padded[0].shape[-1])
    assert valid.shape == (rows,) and bool(valid.all())
    for got, want in zip((feats, targets, lv), (padded[0], padded[2],
                                                padded[3])):
        assert torch.equal(got, want[keep])

    params = port_est.initializer(family)(
        2, generator=torch.Generator().manual_seed(5))
    assert_steps_as_padded(state, step_fn, inputs, params, args.lr,
                           ptrain.make_train_step(port_est.predictor(family)),
                           padded)


@pytest.mark.parametrize("dump", REFIT_DUMPS)
def test_build_trainer_logs_the_rows_it_keeps(tmp_path, caplog, dump):
    """The counter: the labelled rows the step runs on over the dumps'
    slots, logged once at INFO."""
    import logging
    import re

    data, _ = pcmd.load_windows(refit_dump(tmp_path, dump))
    args = pcmd.parse_args(["--data", ".", "--out", "p.npz", "--device",
                            "cpu"])
    with caplog.at_level(logging.INFO, logger="kepler.train"):
        pcmd.build_trainer(args, data, torch.device("cpu"))
    found = re.findall(r"stepping on (\d+) labelled rows of (\d+) slots "
                       r"\(([0-9.]+)%\)", caplog.text)
    assert len(found) == 1
    rows, slots, share = int(found[0][0]), int(found[0][1]), found[0][2]
    lv = data["label_valid"]
    assert rows == int(lv.any(-1).sum())
    assert slots == lv.shape[0] * lv.shape[1] == 64
    assert share == f"{100 * rows / slots:.2f}"
    assert (share == "100.00") == (dump == "every_slot_valid")


def test_build_trainer_logs_the_temporal_slots_it_steps_on(tmp_path,
                                                          caplog):
    """The temporal counter: the labelled rows the step computes on over
    the dumps' slots and their ticks, logged once at INFO."""
    import logging
    import re

    data, _ = pcmd.load_windows(dump_windows(tmp_path, model_mode="temporal"))
    args = pcmd.parse_args(["--data", ".", "--out", "p.npz", "--model",
                            "temporal", "--device", "cpu"])
    with caplog.at_level(logging.INFO, logger="kepler.train"):
        pcmd.build_trainer(args, data, torch.device("cpu"))
    found = re.findall(r"stepping on (\d+) labelled rows of (\d+) slots × "
                       r"(\d+) ticks \(([0-9.]+)%\)", caplog.text)
    assert len(found) == 1
    rows, slots, ticks = (int(x) for x in found[0][:3])
    fh = data["feat_hist"]
    assert slots == fh.shape[0] * fh.shape[1] and ticks == fh.shape[2] == 4
    assert 0 < rows == int(data["label_valid"].any(-1).sum()) < slots
    assert found[0][3] == f"{100 * rows / slots:.2f}"


@pytest.mark.parametrize("dump", REFIT_DUMPS)
def test_build_trainer_logs_the_experts_each_moe_row_goes_through(
        tmp_path, caplog, dump):
    """The moe counter: the labelled rows, the dumps' slots and the
    experts every row runs through (the learned gate mixes them all),
    logged once at INFO."""
    import logging
    import re

    data, _ = pcmd.load_windows(refit_dump(tmp_path, dump))
    args = pcmd.parse_args(["--data", ".", "--out", "p.npz", "--model",
                            "moe", "--device", "cpu"])
    with caplog.at_level(logging.INFO, logger="kepler.train"):
        pcmd.build_trainer(args, data, torch.device("cpu"))
    found = re.findall(r"stepping on (\d+) labelled rows of (\d+) slots, "
                       r"each through (\d+) experts \(([0-9.]+)%\)",
                       caplog.text)
    assert len(found) == 1
    rows, slots, experts = (int(x) for x in found[0][:3])
    lv = data["label_valid"]
    assert rows == int(lv.any(-1).sum()) and slots == lv[..., 0].size == 64
    assert experts == 8  # init_moe's default, which cmd.train builds
    assert found[0][3] == f"{100 * rows / slots:.2f}"


@pytest.mark.parametrize("family", ("linear", "mlp", "deep"))
def test_the_other_single_tick_families_log_their_rows_alone(
        tmp_path, caplog, family):
    import logging

    data, _ = pcmd.load_windows(refit_dump(tmp_path, "padded_slots"))
    args = pcmd.parse_args(["--data", ".", "--out", "p.npz", "--model",
                            family, "--device", "cpu"])
    with caplog.at_level(logging.INFO, logger="kepler.train"):
        pcmd.build_trainer(args, data, torch.device("cpu"))
    rows = int(data["label_valid"].any(-1).sum())
    assert [r.getMessage() for r in caplog.records
            if r.getMessage().startswith("stepping on")] == [
        f"stepping on {rows} labelled rows of 64 slots "
        f"({100 * rows / 64:.2f}%)"]


@pytest.mark.parametrize("route", ("plain", "card"))
@pytest.mark.parametrize("dump", REFIT_DUMPS)
def test_the_moe_refit_is_the_plain_refit(tmp_path, dump, route):
    """Three steps of ``build_trainer(--model moe)`` against the
    benchmark's plain refit (``portbench/reference/refit_moe.py``,
    stepped by its plain AdamW) from the same seed and dumps, on the
    CPU's plain route and under ``nn.card_route`` (the card's
    ``HalfProduct`` with its hi/lo backward): the start bit for bit; the
    losses within rtol 1e-5 (f32 summation order; measured equal); each
    leaf's change by its norm within 1e-5 of the larger of the
    reference leaf's change and the median leaf's (measured ≤ 6.6e-7:
    both sides round the same operands and gradients to bf16, and sum
    in another order). The first step moves only ``w1``, ``b1`` and
    ``w_skip`` (``w1`` starts at zero); the other leaves' gradients
    reach them from the second."""
    import contextlib
    import statistics

    from kepler_tpu_torch.models import nn as pnn
    from portbench.reference import adamw, refit_moe
    from portbench.reference.precision import rounding

    cpu = torch.device("cpu")
    seed = 2**31 + 9
    data, _ = pcmd.load_windows(refit_dump(tmp_path, dump))
    args = pcmd.parse_args(["--data", ".", "--out", "p.npz", "--model",
                            "moe", "--seed", str(seed), "--device", "cpu"])
    route_ctx = (pnn.card_route(cpu) if route == "card"
                 else contextlib.nullcontext())
    with route_ctx:
        state, step_fn, inputs = pcmd.build_trainer(args, data, cpu)
        start = {k: v.detach().clone() for k, v in state.params.items()}
        losses = []
        for _ in range(3):
            state, loss = step_fn(state, *inputs)
            losses.append(float(loss))
    config = {"zones": data["zone_names"],
              "estimator": {"n_experts": 8, "hidden": 128, "n_features": 7}}
    ref = adamw.refit(refit_moe.loss_and_grad, refit_moe.start(seed, config),
                      refit_moe.inputs(data, cpu), adamw.AdamW(lr=args.lr), 3,
                      rounding("bfloat16"))
    assert sorted(ref.start) == sorted(start)
    assert all(torch.equal(start[k], ref.start[k]) for k in start)
    np.testing.assert_allclose(losses, ref.losses, rtol=1e-5)
    end = {k: v.detach() for k, v in state.params.items()}
    got, want = ({k: float(torch.linalg.vector_norm((e[k] - s[k]).double()))
                  for k in start}
                 for e, s in ((end, start), (ref.end, ref.start)))
    median = statistics.median(want.values())
    assert median > 0 and all(want[k] > 0 for k in want)
    for k in start:
        assert abs(got[k] - want[k]) <= 1e-5 * max(want[k], median), k


TEMPORAL_DUMPS = {"three_windows": dict(seed=0),
                  "five_windows": dict(seed=7, n_windows=5)}


@pytest.mark.parametrize("dump", sorted(TEMPORAL_DUMPS))
def test_build_trainer_steps_the_temporal_family_on_labelled_rows(
        tmp_path, dump):
    """``build_trainer(--model temporal)``'s inputs are the labelled rows
    of the padded dumps, in dump order, and three of its steps are three
    steps of ``make_temporal_train_step`` on every padded slot from the
    same seed (``assert_steps_as_padded``)."""
    data, _ = pcmd.load_windows(dump_windows(
        tmp_path, model_mode="temporal", **TEMPORAL_DUMPS[dump]))
    args = pcmd.parse_args(["--data", ".", "--out", "p.npz", "--model",
                            "temporal", "--seed", "5", "--device", "cpu"])
    state, step_fn, inputs = pcmd.build_trainer(args, data,
                                                torch.device("cpu"))
    padded = tuple(torch.from_numpy(data[k]) for k in (
        "feat_hist", "workload_valid", "t_valid", "target_watts",
        "label_valid"))
    keep = padded[4].any(-1)
    rows = int(keep.sum())
    assert 0 < rows < keep.numel()
    _, _, t, f = padded[0].shape
    z = padded[3].shape[-1]
    assert [tuple(x.shape) for x in inputs] == [
        (rows, t, f), (rows,), (rows, t), (rows, z), (rows, z)]
    for got, want in zip(inputs, padded):
        assert got.dtype == want.dtype and torch.equal(got, want[keep])
    assert bool(inputs[1].all())

    params = port_est.initializer("temporal")(
        z, t_max=max(t, 128), generator=torch.Generator().manual_seed(5))
    assert_steps_as_padded(state, step_fn, inputs, params, args.lr,
                           ptrain.make_temporal_train_step(), padded)


@pytest.mark.parametrize("family", FAMILIES)
def test_train_cli_end_to_end_on_cpu(tmp_path, family):
    """Dumps from the port's Aggregator → ``cmd.train --device cpu`` → an
    ``.npz`` that the port's Aggregator takes (and, for temporal, serves
    a window from). Checkpointed halfway and resumed, it ends at the
    straight run's params."""
    mode = "temporal" if family == "temporal" else None
    d = dump_windows(tmp_path, model_mode=mode)
    out, resumed = str(tmp_path / "p.npz"), str(tmp_path / "r.npz")
    steps = "10" if family == "temporal" else "20"
    base = ["--data", d, "--model", family, "--steps", steps, "--lr", "1e-2",
            "--device", "cpu", "--log-every", "5"]
    assert pcmd.main(base + ["--out", out]) == 0
    ck = str(tmp_path / "ck")
    half = str(int(steps) // 2)
    assert pcmd.main(base[:5] + [half] + base[6:]
                     + ["--out", resumed, "--ckpt-dir", ck]) == 0
    assert TrainCheckpointer(ck).latest_step() == int(half)
    assert pcmd.main(base + ["--out", resumed, "--ckpt-dir", ck,
                             "--ckpt-every", "3"]) == 0
    a, b = port_est.load_params(out), port_est.load_params(resumed)
    for x, y in zip(ptrain.param_leaves(a), ptrain.param_leaves(b)):
        assert torch.equal(x, y)
    serve = PAggregator(PServer(), device="cpu", model_mode=family,
                        model_params=a, node_bucket=8, workload_bucket=8,
                        history_window=4)
    serve._check_params_shape()
    assert serve._model_out_dim() == 2
    if family == "temporal":
        assert a["pos_emb"].shape[0] == 128  # t_max = max(T, 128)


def test_train_cli_defaults_to_cuda(tmp_path, caplog):
    d = dump_windows(tmp_path)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default trains on it")
    rc = pcmd.main(["--data", d, "--out", str(tmp_path / "p.npz")])
    assert rc == 1
    assert "CUDA is not available" in caplog.text
    assert not (tmp_path / "p.npz").exists()
    assert pcmd.main(["--data", dump_windows(tmp_path / "x"), "--model",
                      "temporal", "--out", str(tmp_path / "q.npz"),
                      "--device", "cpu"]) == 2  # no history in the dumps
