"""The port's moe and deep estimators and the exact linear fit against the
JAX package's.

Seeded numpy inputs at a small size (E = 3 experts of H = 16; S = 2
stages of D = 16) with pad rows, invalid workloads and a zone with no
labels go through the JAX function and the port's on the CPU, with
non-zero output layers (the initialisers zero them, which would make
every prediction the bias). Tolerances:

- f32 compute: rtol 1e-5 (atol 1e-5 · max|watts|);
- the default bf16 trunk: atol 1e-2 · max|watts| (operands round to bf16
  after f32 sums taken in another order);
- ``fit_linear_exact`` (an SVD either side): rtol 1e-4.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kepler_tpu.models import deep as jdeep
from kepler_tpu.models import estimator as jest
from kepler_tpu.models import linear as jlinear
from kepler_tpu.models import moe as jmoe
from kepler_tpu.models.features import build_features as jax_features
from kepler_tpu_torch.models import deep, linear, moe
from kepler_tpu_torch.models import estimator as port_est
from kepler_tpu_torch.models.features import NUM_FEATURES

E, H = 3, 16
S, D = 2, 16
Z = 4
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def assert_watts(got, want, cd: str) -> None:
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    if cd == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-2 * scale)


def inputs(seed: int, n: int = 5, w: int = 9):
    """Features from the feature builder (so feature 5 is the constant
    bias column), with pad rows: node 4 has no valid workload, about a
    quarter of the rest are invalid."""
    rng = np.random.default_rng(seed)
    valid = rng.random((n, w)) > 0.25
    valid[-1] = False
    cpu = rng.uniform(0.0, 8.0, (n, w)).astype(np.float32)
    denom = (cpu * valid).sum(axis=1).astype(np.float32)
    ratio = rng.uniform(0.1, 1.0, n).astype(np.float32)
    dt = rng.uniform(0.5, 5.0, n).astype(np.float32)
    feats = np.asarray(jax_features(*(jnp.asarray(x) for x in
                                      (cpu, valid, denom, ratio, dt))))
    return feats, valid


def moe_params(seed: int = 0, n_zones: int = Z) -> dict:
    """JAX-initialised MoE params as numpy, non-zero output layers."""
    rng = np.random.default_rng(seed)
    p = {k: np.asarray(v) for k, v in jmoe.init_moe(
        jax.random.PRNGKey(seed), n_zones, n_experts=E, hidden=H).items()}
    p["w1"] = rng.normal(0, 0.3, p["w1"].shape).astype(np.float32)
    p["b1"] = rng.normal(0.5, 0.1, p["b1"].shape).astype(np.float32)
    p["b0"] = rng.normal(0, 0.1, p["b0"].shape).astype(np.float32)
    p["w_skip"] = rng.normal(0, 0.2, p["w_skip"].shape).astype(np.float32)
    return p


def deep_params(seed: int = 0, n_zones: int = Z) -> dict:
    """JAX-initialised deep params as numpy (``blocks`` nested), non-zero
    head and skip path."""
    rng = np.random.default_rng(seed)
    jp = jdeep.init_deep(jax.random.PRNGKey(seed), n_zones, n_stages=S,
                         d_model=D)
    p = {k: np.asarray(v) for k, v in jp.items() if k != "blocks"}
    p["blocks"] = {k: np.asarray(v) for k, v in jp["blocks"].items()}
    p["blocks"]["ln_scale"] = rng.normal(
        1.0, 0.1, p["blocks"]["ln_scale"].shape).astype(np.float32)
    p["blocks"]["b0"] = rng.normal(0, 0.1, p["blocks"]["b0"].shape).astype(
        np.float32)
    p["w_head"] = rng.normal(0, 0.3, p["w_head"].shape).astype(np.float32)
    p["b_head"] = rng.normal(0.5, 0.1, p["b_head"].shape).astype(np.float32)
    p["w_skip"] = rng.normal(0, 0.2, p["w_skip"].shape).astype(np.float32)
    return p


def jtree(p: dict):
    return jax.tree.map(jnp.asarray, p)


# -- models.moe -------------------------------------------------------------------

@pytest.mark.parametrize("cd", ["f32", "bf16"])
def test_expert_forward_and_gate_logits_match_jax(cd):
    p = moe_params(1)
    x = np.random.default_rng(2).normal(0, 2, (E, 11, NUM_FEATURES)).astype(
        np.float32)
    jcd, tcd = DTYPES[cd]
    tp = port_est.params_from_numpy("moe", p)
    want = jmoe.expert_forward(jtree(p), jnp.asarray(x), jcd)
    got = moe.expert_forward(tp, t(x), tcd)
    assert got.dtype == torch.float32 and got.shape == (E, 11, Z)
    assert_watts(got, want, cd)
    feats, _ = inputs(3)
    np.testing.assert_allclose(
        moe.gate_logits(tp, t(feats)).numpy(),
        np.asarray(jmoe.gate_logits(jtree(p), jnp.asarray(feats))),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cd", ["f32", "bf16"])
@pytest.mark.parametrize("routing", ["gate", "expert_id", "expert_id_rows"])
@pytest.mark.parametrize("clamp", [True, False])
def test_predict_moe_matches_jax(cd, routing, clamp):
    p = moe_params(4)
    feats, valid = inputs(5)
    jcd, tcd = DTYPES[cd]
    ids = None
    if routing == "expert_id":  # one type per node, broadcast over W
        ids = np.array([0, 2, 1, 7, -1], np.int32)  # 7, -1: no expert
    elif routing == "expert_id_rows":  # one per workload row
        ids = np.random.default_rng(6).integers(0, E, valid.shape).astype(
            np.int32)
    want = jmoe.predict_moe(jtree(p), jnp.asarray(feats), jnp.asarray(valid),
                            clamp=clamp, compute_dtype=jcd,
                            expert_id=None if ids is None
                            else jnp.asarray(ids))
    got = moe.predict_moe(port_est.params_from_numpy("moe", p), t(feats),
                          t(valid), clamp=clamp, compute_dtype=tcd,
                          expert_id=None if ids is None else t(ids))
    assert got.shape == (5, 9, Z)
    assert np.abs(np.asarray(want)).max() > 0.1
    assert_watts(got, want, cd)
    assert not got.numpy()[~valid].any()
    if routing == "expert_id":  # ids outside [0, E) select no expert
        assert not got.numpy()[3:].any()
    if not clamp:
        assert (got < 0).any() or routing == "expert_id"


@pytest.mark.parametrize("routing", ["gate", "explicit"])
def test_moe_combine_is_the_gated_sum_over_experts(routing):
    """The combine, a broadcast product summed over the expert axis, is
    the contraction ``einsum("enz,ne->nz")`` of the experts' outputs and
    the gates to f32 summation order (rtol 1e-6), and exactly it where a
    one-hot gate picks one expert."""
    p = port_est.params_from_numpy("moe", moe_params(5))
    feats, valid = inputs(6)
    feats, valid = t(feats), t(valid)
    eid = torch.tensor([0, 2, 1, 5, 2]) if routing == "explicit" else None
    got = moe.predict_moe(p, feats, valid, clamp=False, expert_id=eid)
    x = feats.reshape(1, -1, NUM_FEATURES)
    per_expert = moe.expert_forward(p, x.expand(E, *x.shape[1:]))
    if eid is None:
        gates = torch.softmax(moe.gate_logits(p, feats), dim=-1)
    else:
        gates = torch.nn.functional.one_hot(
            eid[:, None].expand(valid.shape), 8)[..., :E].float()
    want = torch.einsum("enz,ne->nz", per_expert, gates.reshape(-1, E))
    want = torch.where(valid[..., None], want.reshape(got.shape), 0.0)
    if eid is None:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    else:
        assert torch.equal(got, want)


def test_moe_module_and_registry():
    p = port_est.params_from_numpy("moe", moe_params(7))
    feats, valid = (t(x) for x in inputs(8))
    assert port_est.predictor("moe") is moe.predict_moe
    module = port_est.estimator_module("moe", p)
    assert isinstance(module, moe.MoEEstimator)
    assert torch.equal(module(feats, valid),
                       moe.predict_moe(p, feats, valid))
    fresh = moe.init_moe(Z, n_experts=E, hidden=H,
                         generator=torch.Generator().manual_seed(0))
    ref = jmoe.init_moe(jax.random.PRNGKey(0), Z, n_experts=E, hidden=H)
    assert {k: tuple(v.shape) for k, v in fresh.items()} == {
        k: v.shape for k, v in ref.items()}
    assert not fresh["w1"].any() and not fresh["w_skip"].any()


# -- models.deep ------------------------------------------------------------------

@pytest.mark.parametrize("cd", ["f32", "bf16"])
def test_block_embed_head_match_jax(cd):
    p = deep_params(9)
    jcd, tcd = DTYPES[cd]
    tp = port_est.params_from_numpy("deep", p)
    feats, valid = inputs(10)
    x = np.asarray(jdeep.embed(jtree(p), jnp.asarray(feats), jcd))
    assert_watts(deep.embed(tp, t(feats), tcd), x, cd)
    block = {k: v[1] for k, v in p["blocks"].items()}
    want = jdeep.block_fn(jtree(block), jnp.asarray(x), jcd)
    got = deep.block_fn({k: v[1] for k, v in tp["blocks"].items()}, t(x),
                        tcd)
    assert_watts(got, want, cd)
    for clamp in (True, False):
        np.testing.assert_allclose(
            deep.head(tp, t(x), t(valid), clamp, features=t(feats)).numpy(),
            np.asarray(jdeep.head(jtree(p), jnp.asarray(x),
                                  jnp.asarray(valid), clamp,
                                  features=jnp.asarray(feats))),
            rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cd", ["f32", "bf16"])
@pytest.mark.parametrize("clamp", [True, False])
def test_predict_deep_matches_jax(cd, clamp):
    p = deep_params(11)
    feats, valid = inputs(12)
    jcd, tcd = DTYPES[cd]
    want = jdeep.predict_deep(jtree(p), jnp.asarray(feats),
                              jnp.asarray(valid), clamp=clamp,
                              compute_dtype=jcd)
    got = deep.predict_deep(port_est.params_from_numpy("deep", p), t(feats),
                            t(valid), clamp=clamp, compute_dtype=tcd)
    assert got.shape == (5, 9, Z)
    assert np.abs(np.asarray(want)).max() > 0.1
    assert_watts(got, want, cd)
    assert not got.numpy()[~valid].any()


def test_deep_module_registry_and_nested_npz(tmp_path):
    p = deep_params(13)
    path = str(tmp_path / "deep.npz")
    jest.save_params(path, jtree(p))
    loaded = port_est.load_params(path)
    assert set(loaded["blocks"]) == set(deep.BLOCK_KEYS)
    tp = port_est.params_from_numpy("deep", p)
    for k in deep.PARAM_KEYS:
        assert torch.equal(loaded[k], tp[k])
    for k in deep.BLOCK_KEYS:
        assert torch.equal(loaded["blocks"][k], tp["blocks"][k])
    port_est.save_params(path, loaded)
    back = jest.load_params(path)
    jax.tree.map(np.testing.assert_array_equal, jtree(p), back)
    feats, valid = (t(x) for x in inputs(14))
    assert port_est.predictor("deep") is deep.predict_deep
    module = port_est.estimator_module("deep", loaded)
    assert isinstance(module, deep.DeepEstimator)
    assert torch.equal(module(feats, valid),
                       deep.predict_deep(loaded, feats, valid))
    fresh = deep.init_deep(Z, n_stages=S, d_model=D,
                           generator=torch.Generator().manual_seed(0))
    ref = jdeep.init_deep(jax.random.PRNGKey(0), Z, n_stages=S, d_model=D)
    assert {k: tuple(v.shape) for k, v in fresh["blocks"].items()} == {
        k: v.shape for k, v in ref["blocks"].items()}
    assert not fresh["w_head"].any() and not fresh["w_skip"].any()


# -- the registry's ModelEstimator --------------------------------------------------

@pytest.mark.parametrize("mode", ["linear", "mlp", "moe", "deep"])
def test_model_estimator_predicts_as_jax(mode):
    """``create`` draws from a seeded ``torch.Generator`` (the shapes of
    JAX's, not its bits); with the same params both predict the same
    watts from the same raw inputs."""
    a = port_est.ModelEstimator.create(mode, Z, seed=3)
    b = port_est.ModelEstimator.create(mode, Z, seed=3)
    ref = jest.ModelEstimator.create(mode, Z, seed=3)
    assert jax.tree.map(np.shape, dict(ref.params)) == jax.tree.map(
        lambda v: tuple(v.shape), a.params)
    assert all(torch.equal(x, y) for x, y in zip(
        jax.tree.leaves(a.params), jax.tree.leaves(b.params)))
    params = {"moe": moe_params, "deep": deep_params}.get(mode)
    params = (params(15) if params else
              jax.tree.map(np.asarray, dict(ref.params)))
    rng = np.random.default_rng(16)
    valid = rng.random((3, 6)) > 0.2
    cpu = rng.uniform(0, 4, (3, 6)).astype(np.float32)
    raw = (cpu, valid, (cpu * valid).sum(1).astype(np.float32),
           np.full(3, 0.7, np.float32), np.full(3, 5.0, np.float32))
    want = jest.ModelEstimator(mode, jtree(params)).predict_watts(
        *(jnp.asarray(x) for x in raw))
    got = port_est.ModelEstimator(
        mode, port_est.params_from_numpy(mode, params)).predict_watts(
            *(t(x) for x in raw))
    assert_watts(got, want, "f32" if mode == "linear" else "bf16")


def test_registry_has_no_unported_modes():
    for mode in ("linear", "mlp", "moe", "deep", "temporal"):
        assert port_est.initializer(mode) is not None
    assert not hasattr(port_est, "NOT_PORTED")
    assert port_est.MOE == jest.MOE and port_est.DEEP == jest.DEEP


# -- models.linear.fit_linear_exact ----------------------------------------------------

def fit_inputs(seed: int, rank_deficient: bool):
    feats, valid = inputs(seed, n=6, w=12)
    rng = np.random.default_rng(seed + 100)
    w_true = rng.normal(0, 2, (NUM_FEATURES, Z)).astype(np.float32)
    targets = (feats @ w_true + rng.normal(0, 0.05, (6, 12, Z))).astype(
        np.float32)
    if rank_deficient:  # feature 0 repeats feature 1, feature 3 is 0
        feats = feats.copy()
        feats[..., 0] = feats[..., 1]
        feats[..., 3] = 0.0
    label_valid = rng.random((6, 12, Z)) > 0.2
    label_valid[..., 2] = False  # a zone with no labels
    return feats, valid, targets, label_valid


@pytest.mark.parametrize("rank_deficient", [False, True])
@pytest.mark.parametrize("per_zone", [False, True])
def test_fit_linear_exact_matches_jax(rank_deficient, per_zone):
    feats, valid, targets, lv = fit_inputs(17, rank_deficient)
    lv_j = jnp.asarray(lv) if per_zone else None
    want = jlinear.fit_linear_exact(jnp.asarray(feats), jnp.asarray(valid),
                                    jnp.asarray(targets), lv_j)
    got = linear.fit_linear_exact(t(feats), t(valid), t(targets),
                                  t(lv) if per_zone else None)
    assert got["weight"].dtype == torch.float32
    assert not got["bias"].any()
    w_want = np.asarray(want["weight"])
    np.testing.assert_allclose(got["weight"].numpy(), w_want, rtol=1e-4,
                               atol=1e-4 * np.abs(w_want).max())
    if per_zone:  # the unlabelled zone's column is the minimum norm: 0
        assert not got["weight"][:, 2].any()


def test_lstsq_min_norm_is_jax_lstsq():
    """Batched, rank-deficient and all-zero systems."""
    rng = np.random.default_rng(18)
    a = rng.normal(size=(3, 40, 7)).astype(np.float32)
    a[1, :, 4] = a[1, :, 2] * 3.0
    a[2] = 0.0
    b = rng.normal(size=(3, 40, 2)).astype(np.float32)
    got = linear.lstsq_min_norm(t(a), t(b)).numpy()
    for i in range(3):
        want = np.asarray(jnp.linalg.lstsq(jnp.asarray(a[i]),
                                           jnp.asarray(b[i]))[0])
        np.testing.assert_allclose(got[i], want, rtol=1e-4, atol=1e-5)
    assert not got[2].any()


# -- served through both Aggregators --------------------------------------------------

@pytest.mark.parametrize("family,trainer", [
    ("moe", "jax"), ("deep", "jax"), ("moe", "port"), ("deep", "port"),
    ("mlp", "port"), ("linear", "port"), ("temporal", "port")])
def test_trained_npz_served_by_both_aggregators(tmp_path, family, trainer):
    """A ``.npz`` trained by either package's ``cmd.train`` (on dumps of
    the port's Aggregator) serves the same windows in both Aggregators:
    the pipelined tier (pallas backend, depth 2) for the single-tick
    families — ratio rows bit-equal, model rows within 1e-3 on the f16
    plane — and the serial rung at bf16 for temporal."""
    from kepler_tpu.cmd import train as jcmd
    from kepler_tpu_torch.cmd import train as pcmd
    from tests.test_torch_aggregator import Pair, assert_same_window
    from tests.test_torch_train import dump_windows
    from tests.test_window_pipeline import churn_schedule

    temporal = family == "temporal"
    d = dump_windows(tmp_path, model_mode="temporal" if temporal else None)
    out = str(tmp_path / "p.npz")
    argv = ["--data", d, "--model", family, "--out", out, "--steps", "15",
            "--log-every", "0"]
    if trainer == "jax":
        assert jcmd.main(argv) == 0
    else:
        assert pcmd.main(argv + ["--device", "cpu"]) == 0
    params = jax.tree.map(np.asarray, jest.load_params(out))
    if temporal:
        pair = Pair(model_mode="temporal", history_window=4,
                    backend="pallas", model_params=params)
    else:
        pair = Pair(model_mode=family, model_params=params,
                    pipeline_depth=2, backend="pallas")
    out_j, out_p = pair.run(churn_schedule(6))
    assert sum(r is not None for r in out_p) >= 5
    for ref, got in zip(out_j, out_p):
        if temporal:
            assert_same_window(ref, got, model="bf16", ratio="serial")
        else:
            assert_same_window(ref, got, model="packed")
    # the trained params (two zones) serve the windows before the zone
    # set widens, with non-zero watts
    trained = [r for r in out_p[:4] if r is not None]
    assert trained and all(len(r.zones) == 2 for r in trained)
    assert max(float(np.abs(r.wl_power_uw[r.mode == 1]).max())
               for r in trained) > 0


def test_aggregator_binary_serves_a_deep_npz_on_cpu(tmp_path):
    """``python -m kepler_tpu_torch.cmd.aggregator --device cpu
    --aggregator.model deep --aggregator.params-path`` with a JAX-written
    deep ``.npz`` (nested ``blocks/*`` keys) serves a model node's
    watts, and stops cleanly on SIGTERM."""
    import os
    import pathlib
    import signal
    import socket
    import subprocess
    import sys
    import time
    import urllib.request

    from kepler_tpu_torch.fleet import wire
    from kepler_tpu_torch.parallel.fleet import MODE_MODEL, NodeReport

    repo = str(pathlib.Path(__file__).resolve().parent.parent)
    params = str(tmp_path / "deep.npz")
    jest.save_params(params, jtree(deep_params(31, n_zones=2)))
    cfg = tmp_path / "agg.yaml"
    cfg.write_text("aggregator:\n  interval: 1s\n")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    base = f"http://127.0.0.1:{port}"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = repo
    proc = subprocess.Popen(
        [sys.executable, "-m", "kepler_tpu_torch.cmd.aggregator", "--device",
         "cpu", "--config.file", str(cfg), "--aggregator.model", "deep",
         "--aggregator.params-path", params, "--no-exporter.prometheus",
         "--aggregator.pipeline-depth", "1",
         "--aggregator.listen-address", f"127.0.0.1:{port}"],
        cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)

    def get(path: str, body: bytes | None = None) -> bytes:
        req = urllib.request.Request(base + path, data=body,
                                     method="POST" if body else "GET")
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.read()

    try:
        deadline = time.monotonic() + 60
        while True:
            assert proc.poll() is None, proc.communicate()[0][-2000:]
            try:
                get("/readyz")
                break
            except OSError:
                assert time.monotonic() < deadline, "never ready"
                time.sleep(0.2)
        cpu = np.random.default_rng(32).uniform(0.5, 4.0, 6).astype(
            np.float32)
        get("/v1/report", wire.encode_report_v2(NodeReport(
            node_name="vm-0", zone_deltas_uj=np.zeros(2, np.float32),
            zone_valid=np.zeros(2, bool), usage_ratio=0.5, cpu_deltas=cpu,
            workload_ids=[f"vm-0/w{i}" for i in range(6)],
            node_cpu_delta=float(cpu.sum()), dt_s=5.0, mode=MODE_MODEL),
            ["dram", "package"], seq=1, run="r1"))
        deadline = time.monotonic() + 30
        while True:
            try:
                res = json.loads(get("/v1/results?node=vm-0"))
                break
            except OSError:
                assert time.monotonic() < deadline, "no window published"
                time.sleep(0.2)
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            out, _ = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
    watts = np.asarray([w["power_uw"] for w in res["workloads"]])
    assert watts.shape == (6, 2) and np.isfinite(watts).all()
    assert watts.max() > 0
    assert proc.returncode == 0, out[-2000:]
    assert "Graceful shutdown completed" in out and " on cpu" in out
    assert "loaded deep params" in out
