"""The port's temporal estimator path against the JAX package's.

- ``models.nn``: ``layer_norm`` (population variance), ``acc_matmul``
  (bf16 operands, f32 result), ``glorot``.
- ``models.temporal``: ``init_temporal`` shapes, JAX params through
  ``params_from_numpy`` and JAX ``.npz`` files, ``predict_temporal`` on
  the fast path and on the full trunk (dense and through
  ``pallas_attention_fn``) over ragged, gapped and empty windows.
- ``monitor.history``: ``HistoryBuffer`` windows byte-identical over a
  churn schedule.
- ``parallel.aggregator_core``: ``make_temporal_fleet_program`` (einsum
  and pallas, accuracy mode off and on) and ``make_fleet_program`` against
  the JAX programs, all eight ``FleetResult`` fields.

Seeded numpy inputs go to both packages; JAX's Pallas kernels run in
interpret mode on the CPU. Tolerances on model watts: f32 compute (and
accuracy mode) rtol 1e-4, atol 1e-5 W; bf16 compute rtol 1e-2, atol
1e-2 · max|watts| (bf16 operand rounding after f32 sums that differ in
order); ratio rows rtol 1e-6.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kepler_tpu.models import estimator as jest
from kepler_tpu.models import nn as jnn
from kepler_tpu.models.temporal import init_temporal as jinit
from kepler_tpu.models.temporal import predict_temporal as jpredict
from kepler_tpu.monitor.history import HistoryBuffer as JaxHistory
from kepler_tpu.ops.attention import full_attention as jfull
from kepler_tpu.ops.pallas_attention import pallas_attention_fn as jpal_fn
from kepler_tpu.parallel import aggregator_core as jcore
from kepler_tpu.parallel.fleet import NodeReport as JaxReport
from kepler_tpu.parallel.fleet import assemble_fleet_batch as jax_assemble
from kepler_tpu.parallel.mesh import make_mesh
from kepler_tpu.resource.informer import FeatureBatch as JaxBatch
from kepler_tpu_torch.models import estimator as port_est
from kepler_tpu_torch.models import nn as tnn
from kepler_tpu_torch.models.temporal import (PARAM_KEYS, TemporalEstimator,
                                              init_temporal, predict_temporal)
from kepler_tpu_torch.monitor.history import HistoryBuffer
from kepler_tpu_torch.ops.attention import full_attention
from kepler_tpu_torch.ops.cuda_attention import pallas_attention_fn
from kepler_tpu_torch.parallel import aggregator_core as tcore
from kepler_tpu_torch.parallel.fleet import (MODE_MODEL, NodeReport,
                                             assemble_fleet_batch)
from kepler_tpu_torch.resource.informer import FeatureBatch

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def assert_watts(got: np.ndarray, want: np.ndarray, cd: str,
                 scale: float = 1.0) -> None:
    """Model watts (``scale`` = 1e6 for µW) within the stated tolerance."""
    if cd == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-2,
                                   atol=1e-2 * np.abs(want).max())


# -- models.nn ------------------------------------------------------------------

def test_layer_norm_is_population_variance_as_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(2.0, 3.0, (5, 7, 32)).astype(np.float32)
    scale = rng.normal(1.0, 0.1, 32).astype(np.float32)
    bias = rng.normal(0.0, 0.1, 32).astype(np.float32)
    want = np.asarray(jnn.layer_norm(*(jnp.asarray(a)
                                       for a in (x, scale, bias))))
    got = tnn.layer_norm(*(torch.from_numpy(a)
                           for a in (x, scale, bias))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the unbiased variance (torch.var's default) is a different answer
    t = torch.from_numpy(x)
    unbiased = (t - t.mean(-1, keepdim=True)) * torch.rsqrt(
        t.var(-1, keepdim=True) + tnn.LN_EPS)
    assert not np.allclose(unbiased.numpy() * scale + bias, want,
                           rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("cd", ["f32", "bf16"])
def test_acc_matmul_rounds_operands_and_keeps_an_f32_result(cd):
    rng = np.random.default_rng(1)
    a = rng.normal(size=(64, 96)).astype(np.float32)
    b = rng.normal(size=(96, 48)).astype(np.float32)
    jcd, tcd = DTYPES[cd]
    want = np.asarray(jnn.acc_matmul(jnp.asarray(a), jnp.asarray(b), jcd))
    got = tnn.acc_matmul(torch.from_numpy(a), torch.from_numpy(b), tcd)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if cd == "bf16":
        # a bare bf16 matmul rounds its RESULT to bf16: another answer
        bare = (torch.from_numpy(a).bfloat16()
                @ torch.from_numpy(b).bfloat16()).float().numpy()
        assert np.abs(bare - want).max() > 10 * np.abs(got.numpy()
                                                      - want).max()


def test_glorot_scale_over_the_last_two_dims():
    gen = torch.Generator().manual_seed(0)
    w = tnn.glorot((8, 200, 300), gen)
    assert w.shape == (8, 200, 300) and w.dtype == torch.float32
    assert abs(float(w.std()) / np.sqrt(2.0 / 500) - 1) < 0.02


# -- models.temporal --------------------------------------------------------------

def jax_params(z: int = 4, d_model: int = 32, t_max: int = 8,
               seed: int = 0) -> dict:
    """JAX-initialised temporal params as numpy, with non-zero heads."""
    rng = np.random.default_rng(seed)
    p = {k: np.asarray(v) for k, v in jinit(
        jax.random.PRNGKey(seed), z, d_model=d_model, t_max=t_max).items()}
    p["w_head"] = rng.normal(0.0, 0.2, p["w_head"].shape).astype(np.float32)
    p["w_skip"] = rng.normal(0.0, 0.1, p["w_skip"].shape).astype(np.float32)
    p["b_head"] = np.full(z, 0.3, np.float32)
    return p


def history_inputs(seed: int, n: int = 3, w: int = 5, t: int = 8):
    """feat_hist [n, w, t, 7], workload_valid [n, w] and t_valid with
    right-padded ragged windows, gapped windows and empty windows."""
    rng = np.random.default_rng(seed)
    hist = rng.uniform(0.0, 3.0, (n, w, t, 7)).astype(np.float32)
    hist[..., 5] = 1.0
    lengths = rng.integers(0, t + 1, (n, w))
    tv = np.arange(t)[None, None, :] < lengths[..., None]
    tv[0, 0] = False  # empty window
    tv[0, 1] = True  # full window
    tv[1, 0] = False
    tv[1, 0, [0, 2, 5]] = True  # gapped
    tv[1, 1] = False
    tv[1, 1, [1, 3, 4]] = True  # leading gap
    tv[2, 2, ::2] = True  # alternating
    wv = rng.random((n, w)) > 0.2
    wv[0, :2] = True
    return hist, wv, tv


def test_init_temporal_shapes_match_jax_and_seed_is_a_generator():
    ref = jinit(jax.random.PRNGKey(0), 4)
    a = init_temporal(4, generator=torch.Generator().manual_seed(3))
    b = init_temporal(4, generator=torch.Generator().manual_seed(3))
    assert set(a) == set(ref) == set(PARAM_KEYS)
    for k in ref:
        assert tuple(a[k].shape) == tuple(np.shape(ref[k])), k
        assert a[k].dtype == torch.float32
        assert torch.equal(a[k], b[k])
    assert float(a["pos_emb"].std()) == pytest.approx(0.02, rel=0.1)
    for k in ("w_head", "b_head", "w_skip"):
        assert not a[k].any()
    assert torch.equal(a["ln1_scale"], torch.ones(128))


PATHS = ["fast", "trunk_dense", "trunk_pallas"]


def jax_attention(path: str, jcd):
    if path == "trunk_dense":
        return lambda q, k, v, tv: jfull(q, k, v, causal=True, t_valid=tv,
                                         compute_dtype=jcd)
    return jpal_fn(compute_dtype=jcd) if path == "trunk_pallas" else None


def port_attention(path: str, tcd):
    if path == "trunk_dense":
        return lambda q, k, v, tv: full_attention(q, k, v, causal=True,
                                                  t_valid=tv,
                                                  compute_dtype=tcd)
    return pallas_attention_fn(compute_dtype=tcd) \
        if path == "trunk_pallas" else None


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("cd", ["f32", "bf16"])
def test_predict_temporal_matches_jax(path, cd):
    params = jax_params()
    hist, wv, tv = history_inputs(4)
    jcd, tcd = DTYPES[cd]
    want = np.asarray(jpredict(params, jnp.asarray(hist), jnp.asarray(wv),
                               jnp.asarray(tv), compute_dtype=jcd,
                               attention_fn=jax_attention(path, jcd)))
    got = predict_temporal(port_est.params_from_numpy("temporal", params),
                           torch.from_numpy(hist), torch.from_numpy(wv),
                           torch.from_numpy(tv), compute_dtype=tcd,
                           attention_fn=port_attention(path, tcd))
    assert got.shape == (3, 5, 4) and got.dtype == torch.float32
    got = got.numpy()
    assert np.isfinite(got).all()
    assert np.all(got[~wv] == 0.0) and np.all(got >= 0.0)
    assert np.abs(got).max() > 0.1  # the heads carry real watts
    assert_watts(got, want, cd)


def test_fast_path_equals_full_trunk_and_handles_no_t_valid():
    """The single-query fast path is the full trunk's last position (f32),
    and t_valid=None means every tick is valid."""
    params = port_est.params_from_numpy("temporal", jax_params(seed=5))
    hist, wv, tv = (torch.from_numpy(x) for x in history_inputs(6))
    fast = predict_temporal(params, hist, wv, tv, compute_dtype=torch.float32)
    full = predict_temporal(params, hist, wv, tv, compute_dtype=torch.float32,
                            attention_fn=pallas_attention_fn(
                                compute_dtype=torch.float32))
    np.testing.assert_allclose(fast.numpy(), full.numpy(), rtol=1e-4,
                               atol=1e-5)
    every = predict_temporal(params, hist, wv)
    np.testing.assert_array_equal(every.numpy(), predict_temporal(
        params, hist, wv, torch.ones(tv.shape, dtype=torch.bool)).numpy())


def test_late_tick_window_follows_jax_on_both_paths():
    """A window whose only valid tick lies after ``last`` = count − 1 (a
    single late tick) is where the JAX package's fast path and full trunk
    part: the trunk's query at ``last`` sees no key, the fast path's
    all-masked softmax spreads evenly. The port follows each JAX path."""
    params = jax_params(seed=9)
    hist, wv, tv = history_inputs(10)
    tv[2, 3] = False
    tv[2, 3, -1] = True
    tparams = port_est.params_from_numpy("temporal", params)
    outs = {}
    for path in ("fast", "trunk_pallas"):
        want = np.asarray(jpredict(
            params, jnp.asarray(hist), jnp.asarray(wv), jnp.asarray(tv),
            compute_dtype=jnp.float32,
            attention_fn=jax_attention(path, jnp.float32)))
        got = predict_temporal(
            tparams, torch.from_numpy(hist), torch.from_numpy(wv),
            torch.from_numpy(tv), compute_dtype=torch.float32,
            attention_fn=port_attention(path, torch.float32)).numpy()
        assert_watts(got, want, "f32")
        outs[path] = got
    assert not np.allclose(outs["fast"][2, 3], outs["trunk_pallas"][2, 3],
                           rtol=1e-3)


@pytest.mark.parametrize("clamp", [True, False])
def test_npz_from_jax_loads_and_predicts(tmp_path, clamp):
    params = jax_params(seed=2)
    path = str(tmp_path / "temporal.npz")
    jest.save_params(path, params)
    loaded = port_est.load_params(path)
    assert set(loaded) == set(params)
    for k in params:
        np.testing.assert_array_equal(loaded[k].numpy(), params[k])
    hist, wv, tv = history_inputs(3)
    want = np.asarray(jpredict(params, jnp.asarray(hist), jnp.asarray(wv),
                               jnp.asarray(tv), clamp=clamp,
                               compute_dtype=jnp.float32))
    got = predict_temporal(loaded, torch.from_numpy(hist),
                           torch.from_numpy(wv), torch.from_numpy(tv),
                           clamp=clamp, compute_dtype=torch.float32).numpy()
    assert_watts(got, want, "f32")
    if not clamp:
        assert (got < 0).any()


def test_registry_serves_temporal_as_jax_does():
    params = jax_params(seed=7)
    init = port_est.initializer("temporal")
    fresh = init(4, d_model=32, t_max=8,
                 generator=torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in fresh.items()} == {
        k: v.shape for k, v in params.items()}
    tparams = port_est.params_from_numpy("temporal", params)
    module = port_est.estimator_module("temporal", tparams)
    assert isinstance(module, TemporalEstimator)
    hist, wv, tv = (torch.from_numpy(x) for x in history_inputs(8))
    np.testing.assert_array_equal(
        module(hist, wv, tv).numpy(),
        predict_temporal(tparams, hist, wv, tv).numpy())
    with pytest.raises(ValueError, match="history windows"):
        port_est.predictor("temporal")
    assert port_est.NOT_PORTED == ("moe", "deep")


# -- monitor.history ------------------------------------------------------------------

def churn_schedule(seed: int, ticks: int = 14):
    """Per tick (ids, cpu_deltas, node_cpu_delta, usage_ratio, dt): ids
    leave and join, one tick is empty, one has dt = 0, one denom = 0."""
    rng = np.random.default_rng(seed)
    ids = [f"w{i}" for i in range(6)]
    fresh = 6
    out = []
    for t in range(ticks):
        if t and t % 3 == 0:
            ids = ids[1:] + [f"w{fresh}"]
            fresh += 1
        live = [] if t == 7 else [i for i in ids if rng.random() > 0.1]
        cpu = rng.uniform(0.0, 4.0, len(live)).astype(np.float32)
        denom = 0.0 if t == 9 else float(cpu.sum())
        out.append((live, cpu, denom, float(rng.uniform(0.1, 1.0)),
                    0.0 if t == 5 else float(rng.choice([1.0, 5.0]))))
    return out


@pytest.mark.parametrize("window,evict_after", [(5, 2), (16, 0), (1, 3)])
def test_history_buffer_windows_byte_identical(window, evict_after):
    port, ref = (HistoryBuffer(window=window, evict_after=evict_after),
                 JaxHistory(window=window, evict_after=evict_after))
    for live, cpu, denom, ratio, dt in churn_schedule(window + evict_after):
        kinds = np.zeros(len(live), np.int8)
        port.push(FeatureBatch(kinds=kinds, ids=list(live), cpu_deltas=cpu,
                               node_cpu_delta=denom, usage_ratio=ratio), dt)
        ref.push(JaxBatch(kinds=kinds, ids=list(live), cpu_deltas=cpu,
                          node_cpu_delta=denom, usage_ratio=ratio), dt)
        assert len(port) == len(ref)
        ask = sorted(set(live) | {"w0", "w3", "unknown"})
        (f, v), (fr, vr) = port.window_arrays(ask), ref.window_arrays(ask)
        assert f.dtype == fr.dtype and f.shape == fr.shape
        assert f.tobytes() == fr.tobytes() and v.tobytes() == vr.tobytes()


# -- parallel.aggregator_core -----------------------------------------------------------

def fleet_reports(seed: int, n: int, z: int):
    """Kwargs of n node reports: ragged workloads (some nodes empty),
    mixed modes, dt edge cases."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        w = 0 if i == 2 else int(rng.integers(1, 9))
        cpu = rng.uniform(0.1, 5.0, w).astype(np.float32)
        out.append(dict(
            node_name=f"n{i}",
            zone_deltas_uj=rng.uniform(1e7, 1e8, z).astype(np.float32),
            zone_valid=rng.uniform(size=z) > 0.2,
            usage_ratio=float(rng.uniform(-0.1, 1.1)), cpu_deltas=cpu,
            workload_ids=[f"n{i}-w{j}" for j in range(w)],
            node_cpu_delta=float(cpu.sum()),
            dt_s=float(rng.choice([0.0, 5.0, 2.5])),
            mode=MODE_MODEL if i % 2 else 0))
    return out


def history_for(batch, t: int, seed: int):
    """[N, W, T, 7] windows for the batch from a few ticks of history."""
    rng = np.random.default_rng(seed)
    n, w = batch.cpu_deltas.shape
    hist = np.zeros((n, w, t, 7), np.float32)
    tv = np.zeros((n, w, t), bool)
    for i in range(batch.n_nodes):
        buf = HistoryBuffer(window=t)
        ids = batch.workload_ids[i]
        for _ in range(int(rng.integers(1, t + 3))):
            keep = [x for x in ids if rng.random() > 0.2]
            cpu = rng.uniform(0.1, 5.0, len(keep)).astype(np.float32)
            buf.push(FeatureBatch(kinds=np.zeros(len(keep), np.int8),
                                  ids=keep, cpu_deltas=cpu,
                                  node_cpu_delta=float(cpu.sum()),
                                  usage_ratio=0.5), 5.0)
        if ids:
            f, v = buf.window_arrays(ids)
            hist[i, :len(ids)], tv[i, :len(ids)] = f, v
    return hist, tv


def batches(n: int = 8, z: int = 4, seed: int = 11):
    kw = fleet_reports(seed, n, z)
    port = assemble_fleet_batch([NodeReport(**k) for k in kw], n_zones=z,
                                node_bucket=8, workload_bucket=16)
    ref = jax_assemble([JaxReport(**k) for k in kw], n_zones=z,
                       node_bucket=8, workload_bucket=16)
    return port, ref


FIELDS = ("node_energy_uj", "node_active_uj", "node_idle_uj",
          "node_power_uw", "node_active_power_uw", "node_idle_power_uw",
          "workload_energy_uj", "workload_power_uw")


def assert_fleet_results(got, want, mode: np.ndarray, cd: str) -> None:
    model = mode == MODE_MODEL
    assert tcore.FleetResult._fields == FIELDS
    for name in FIELDS:
        a = getattr(got, name).numpy()
        b = np.asarray(getattr(want, name))
        assert a.shape == b.shape and a.dtype == np.float32, name
        np.testing.assert_allclose(a[~model], b[~model], rtol=1e-6,
                                   atol=1e-6 * max(np.abs(b).max(), 1.0),
                                   err_msg=name)
        if model.any():
            assert_watts(a[model], b[model], cd, scale=1e6)


@pytest.mark.parametrize("backend", ["einsum", "pallas"])
@pytest.mark.parametrize("accuracy", [False, True])
def test_temporal_fleet_program_matches_jax(backend, accuracy):
    port_batch, ref_batch = batches()
    params = jax_params(seed=12)
    hist, tv = history_for(port_batch, 8, seed=13)
    want = jcore.run_fleet_attribution(
        jcore.make_temporal_fleet_program(
            make_mesh(devices=jax.devices()[:1]), backend=backend,
            accuracy_mode=accuracy),
        ref_batch, {k: jnp.asarray(v) for k, v in params.items()},
        hist, tv)
    program = tcore.make_temporal_fleet_program(
        device="cpu", backend=backend, accuracy_mode=accuracy)
    got = tcore.run_fleet_attribution(
        program, port_batch, port_est.params_from_numpy("temporal", params),
        hist, tv)
    assert_fleet_results(got, want, port_batch.mode,
                         "f32" if accuracy else "bf16")
    # the program is the temporal_fleet_program function
    direct = tcore.temporal_fleet_program(
        port_est.params_from_numpy("temporal", params),
        *(torch.as_tensor(getattr(port_batch, f)) for f in (
            "zone_deltas_uj", "zone_valid", "usage_ratio", "cpu_deltas",
            "workload_valid", "node_cpu_delta", "dt_s", "mode")),
        torch.from_numpy(hist), torch.from_numpy(tv),
        accuracy_mode=accuracy)
    for a, b in zip(got, direct):
        assert torch.equal(a, b)


@pytest.mark.parametrize("model_mode,accuracy", [
    (None, False), ("linear", False), ("linear", True), ("mlp", True),
    ("mlp", False)])
@pytest.mark.parametrize("backend", ["einsum", "pallas"])
def test_fleet_program_matches_jax(model_mode, accuracy, backend):
    """The single-tick serial-rung program. The MLP serves a bf16 trunk
    by default and f32 in accuracy mode, in both packages. bf16: rtol
    1e-2 with atol 1e-2 · max|watts| (operands round to bf16 after f32
    sums taken in another order); f32: rtol 1e-4."""
    from tests.test_torch_packed import jax_params as single_tick_params

    port_batch, ref_batch = batches(seed=21)
    params = single_tick_params(model_mode, 4)
    want = jcore.run_fleet_attribution(
        jcore.make_fleet_program(make_mesh(devices=jax.devices()[:1]),
                                 model_mode=model_mode, backend=backend,
                                 accuracy_mode=accuracy),
        ref_batch, None if params is None else {
            k: jnp.asarray(v) for k, v in params.items()})
    program = tcore.make_fleet_program(device="cpu", model_mode=model_mode,
                                       backend=backend,
                                       accuracy_mode=accuracy)
    got = tcore.run_fleet_attribution(
        program, port_batch, None if params is None else
        port_est.params_from_numpy(model_mode, params))
    mode = port_batch.mode if model_mode else np.zeros_like(port_batch.mode)
    bf16 = model_mode == "mlp" and not accuracy
    assert_fleet_results(got, want, mode, "bf16" if bf16 else "f32")


def test_accuracy_mode_predictor_sets_f32_compute_for_temporal_only():
    """The JAX rule: every mode but "linear" is served with
    ``compute_dtype=f32`` in accuracy mode; "linear" is left as it is."""
    seen = {}

    def fake(params, feats, valid, **kw):
        seen.update(kw)
        return feats

    assert tcore.accuracy_mode_predictor(fake, "linear") is fake
    for mode in ("mlp", "temporal"):
        seen.clear()
        tcore.accuracy_mode_predictor(fake, mode)(None, 1, 2, t_valid=3)
        assert seen == {"compute_dtype": torch.float32, "t_valid": 3}
    seen.clear()
    tcore.accuracy_mode_predictor(fake, "mlp")(None, 1, 2)
    assert seen == {"compute_dtype": torch.float32}


def test_fleet_programs_take_a_device():
    prog = tcore.make_temporal_fleet_program(device="cpu")
    assert prog.device == torch.device("cpu")
    with pytest.raises(ValueError, match="unknown attribution backend"):
        tcore.make_fleet_program(device="cpu", backend="cuda")
