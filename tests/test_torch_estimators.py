"""The port's estimators and parameter files against the JAX package's.

A ``.npz`` written by the JAX ``save_params`` loads in the port as it
is, ``params_from_numpy`` carries in-memory JAX params across, and the
port's ``predict_linear`` / ``predict_mlp`` (tanh GELU) match the JAX
predictors: at f32 compute to rtol 1e-5, and ``predict_mlp``'s default
bf16 trunk within rtol 1e-2 and atol 1e-2 · max|watts| (operands round
to bf16 after f32 sums taken in another order).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kepler_tpu.models import estimator as jest
from kepler_tpu.models.features import build_features as jax_features
from kepler_tpu.models.linear import init_linear, predict_linear as jlin
from kepler_tpu.models.mlp import init_mlp, predict_mlp as jmlp
from kepler_tpu_torch.models import estimator as port_est
from kepler_tpu_torch.models.features import NUM_FEATURES, build_features
from kepler_tpu_torch.models.linear import predict_linear
from kepler_tpu_torch.models.mlp import init_mlp as port_init_mlp
from kepler_tpu_torch.models.mlp import predict_mlp


def feature_inputs(seed: int, n: int = 6, w: int = 11):
    rng = np.random.default_rng(seed)
    valid = rng.random((n, w)) > 0.25
    cpu = rng.uniform(0.0, 8.0, (n, w)).astype(np.float32)
    denom = (cpu * valid).sum(axis=1).astype(np.float32)
    denom[0] = 0.0
    ratio = rng.uniform(0.0, 1.0, n).astype(np.float32)
    dt = rng.uniform(0.5, 5.0, n).astype(np.float32)
    dt[1] = 0.0
    return cpu, valid, denom, ratio, dt


def test_features_match_jax():
    inputs = feature_inputs(0)
    ref = np.asarray(jax_features(*[jnp.asarray(x) for x in inputs]))
    out = build_features(*[torch.from_numpy(x) for x in inputs]).numpy()
    assert out.shape == ref.shape == (6, 11, NUM_FEATURES)
    np.testing.assert_allclose(out, ref, rtol=1e-6)


def trained(params: dict, seed: int) -> dict:
    """Non-zero heads, so predictions are not trivially the bias."""
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(0.0, 0.1, np.shape(v)).astype(np.float32)
                if k in ("w2", "w_skip", "weight") else np.asarray(v))
            for k, v in params.items()}


@pytest.mark.parametrize("mode", ["linear", "mlp"])
def test_npz_from_jax_loads_and_predicts(tmp_path, mode):
    z = 4
    key = jax.random.PRNGKey(11)
    params = trained(dict(init_linear(key, z) if mode == "linear"
                          else init_mlp(key, z)), 3)
    path = str(tmp_path / f"{mode}.npz")
    jest.save_params(path, params)

    loaded = port_est.load_params(path)
    assert set(loaded) == set(params)
    for k in params:
        assert loaded[k].dtype == torch.float32
        np.testing.assert_array_equal(loaded[k].numpy(), params[k])

    cpu, valid, denom, ratio, dt = feature_inputs(1)
    feats = jax_features(*[jnp.asarray(x) for x in
                           (cpu, valid, denom, ratio, dt)])
    if mode == "linear":
        ref = jlin(params, feats, jnp.asarray(valid))
    else:
        ref = jmlp(params, feats, jnp.asarray(valid),
                   compute_dtype=jnp.float32)
    tfeats = torch.from_numpy(np.array(feats))
    tvalid = torch.from_numpy(valid)
    kw = {} if mode == "linear" else {"compute_dtype": torch.float32}
    out = port_est.predictor(mode)(loaded, tfeats, tvalid, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    # the nn.Module form computes the same function
    module = port_est.estimator_module(mode, port_est.params_from_numpy(
        mode, params))
    np.testing.assert_allclose(module(tfeats, tvalid, **kw).numpy(),
                               out.numpy(), rtol=1e-6, atol=1e-7)


def test_nested_npz_round_trip(tmp_path):
    """One level of nesting flattens to "outer/inner" keys both ways."""
    params = {"a": np.ones(3, np.float32),
              "blocks": {"w": np.full((2, 2), 2.0, np.float32)}}
    path = str(tmp_path / "nested.npz")
    port_est.save_params(path, {"a": torch.ones(3),
                             "blocks": {"w": torch.full((2, 2), 2.0)}})
    back = jest.load_params(path)
    np.testing.assert_array_equal(np.asarray(back["blocks"]["w"]),
                                  params["blocks"]["w"])
    jest.save_params(path, params)
    loaded = port_est.load_params(path)
    np.testing.assert_array_equal(loaded["blocks"]["w"].numpy(),
                                  params["blocks"]["w"])
    with np.load(path, allow_pickle=False) as data:
        assert sorted(data.files) == ["a", "blocks/w"]


def test_mlp_gelu_is_tanh_and_f32():
    params = trained(dict(init_mlp(jax.random.PRNGKey(2), 2)), 4)
    feats = np.random.default_rng(5).normal(
        0, 2, (3, 5, NUM_FEATURES)).astype(np.float32)
    valid = np.ones((3, 5), bool)
    ref = jmlp(params, jnp.asarray(feats), jnp.asarray(valid),
               compute_dtype=jnp.float32, clamp=False)
    out = predict_mlp(port_est.params_from_numpy("mlp", params),
                      torch.from_numpy(feats), torch.from_numpy(valid),
                      clamp=False, compute_dtype=torch.float32)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    lin = trained(dict(init_linear(jax.random.PRNGKey(0), 2)), 1)
    np.testing.assert_allclose(
        predict_linear(port_est.params_from_numpy("linear", lin),
                       torch.from_numpy(feats), torch.from_numpy(valid),
                       clamp=False).numpy(),
        np.asarray(jlin(lin, jnp.asarray(feats), jnp.asarray(valid),
                        clamp=False)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("clamp", [True, False])
def test_predict_mlp_bf16_default_matches_jax(clamp):
    """The default compute is a bf16 trunk in both packages (non-zero
    output head, ragged validity)."""
    params = trained(dict(init_mlp(jax.random.PRNGKey(6), 4)), 7)
    rng = np.random.default_rng(8)
    feats = rng.normal(0, 2, (4, 9, NUM_FEATURES)).astype(np.float32)
    valid = rng.random((4, 9)) > 0.3
    assert np.abs(params["w2"]).max() > 0
    ref = np.asarray(jmlp(params, jnp.asarray(feats), jnp.asarray(valid),
                          clamp=clamp))
    tparams = port_est.params_from_numpy("mlp", params)
    out = predict_mlp(tparams, torch.from_numpy(feats),
                      torch.from_numpy(valid), clamp=clamp).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-2,
                               atol=1e-2 * np.abs(ref).max())
    # the bf16 trunk is not the f32 one: the default really rounds
    f32 = predict_mlp(tparams, torch.from_numpy(feats),
                      torch.from_numpy(valid), clamp=clamp,
                      compute_dtype=torch.float32).numpy()
    assert not np.array_equal(out, f32)
    assert not out[~valid].any()
    module = port_est.estimator_module("mlp", tparams)
    assert torch.equal(module(torch.from_numpy(feats),
                              torch.from_numpy(valid)),
                       predict_mlp(tparams, torch.from_numpy(feats),
                                   torch.from_numpy(valid)))


def test_registry_modes():
    assert port_est.predictor("ratio") is None
    # temporal is ported but has no single-tick predictor, as in JAX
    with pytest.raises(ValueError, match="history windows") as port_err:
        port_est.predictor("temporal")
    with pytest.raises(ValueError, match="history windows") as jax_err:
        jest.predictor("temporal")
    assert str(port_err.value) == str(jax_err.value).replace(
        "make_temporal_program", "make_temporal_fleet_program")
    assert port_est.initializer("temporal") is not None
    for mode in ("moe", "deep"):  # ported: the JAX registry's entries
        assert (port_est.predictor(mode).__name__
                == jest.predictor(mode).__name__)
        assert (port_est.initializer(mode).__name__
                == jest.initializer(mode).__name__)
    with pytest.raises(ValueError, match="unknown estimator"):
        port_est.predictor("bogus")
    with pytest.raises(ValueError, match="no learned parameters"):
        port_est.initializer("ratio")


def test_init_shapes_match_jax_and_seed_is_a_generator():
    ref = init_mlp(jax.random.PRNGKey(0), 4)
    a = port_init_mlp(4, generator=torch.Generator().manual_seed(0))
    b = port_init_mlp(4, generator=torch.Generator().manual_seed(0))
    for k in ref:
        assert tuple(a[k].shape) == tuple(np.shape(ref[k]))
        assert torch.equal(a[k], b[k])
