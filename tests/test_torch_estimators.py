"""The port's estimators and parameter files against the JAX package's.

A ``.npz`` written by the JAX ``save_params`` loads in the port as it
is, ``params_from_numpy`` carries in-memory JAX params across, and the
port's ``predict_linear`` / ``predict_mlp`` (f32, tanh GELU) match the
JAX predictors at f32 compute to rtol 1e-5.
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
    out = port_est.predictor(mode)(loaded, tfeats, tvalid)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    # the nn.Module form computes the same function
    module = port_est.estimator_module(mode, port_est.params_from_numpy(
        mode, params))
    np.testing.assert_allclose(module(tfeats, tvalid).numpy(), out.numpy(),
                               rtol=1e-6, atol=1e-7)


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
                      clamp=False)
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


def test_registry_modes():
    assert port_est.predictor("ratio") is None
    for mode in ("temporal", "moe", "deep"):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            port_est.predictor(mode)
        with pytest.raises(NotImplementedError, match="not yet ported"):
            port_est.initializer(mode)
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
