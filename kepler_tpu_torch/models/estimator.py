"""Estimator registry: the power backends behind one interface.

Modes, as in ``kepler_tpu.models.estimator``:
  "ratio"    — RAPL proportional attribution (no learned parameters)
  "linear"   — linear regression from features
  "mlp"      — MLP from features
  "temporal" — causal attention over feature HISTORY windows
               ([.., W, T, F]; served by ``models.temporal.predict_temporal``
               or ``parallel.make_temporal_fleet_program`` fed by
               ``monitor.HistoryBuffer``, not by :func:`predictor`)
  "moe"      — mixture of per-node-type experts (``models.moe``)
  "deep"     — deep residual stack (``models.deep``)

Parameters are plain dicts of tensors with the JAX package's keys (deep's
``blocks`` one level nested), so its ``.npz`` parameter files
(``save_params``) load here as they are and :func:`params_from_numpy`
carries its in-memory params across.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Mapping

import numpy as np
import torch
from torch import nn

from kepler_tpu_torch.models.deep import (DeepEstimator, init_deep,
                                          predict_deep)
from kepler_tpu_torch.models.features import build_features
from kepler_tpu_torch.models.linear import (LinearEstimator, init_linear,
                                            predict_linear)
from kepler_tpu_torch.models.mlp import MLPEstimator, init_mlp, predict_mlp
from kepler_tpu_torch.models.moe import MoEEstimator, init_moe, predict_moe
from kepler_tpu_torch.models.temporal import TemporalEstimator, init_temporal

RATIO = "ratio"
LINEAR = "linear"
MLP = "mlp"
TEMPORAL = "temporal"
MOE = "moe"
DEEP = "deep"

# single-tick predictors: (params, features [.., W, F], workload_valid) →
# watts. TEMPORAL consumes [.., W, T, F] history windows and is not here.
_PREDICTORS: dict[str, Callable] = {LINEAR: predict_linear, MLP: predict_mlp,
                                    MOE: predict_moe, DEEP: predict_deep}
_INITIALIZERS: dict[str, Callable] = {LINEAR: init_linear, MLP: init_mlp,
                                      TEMPORAL: init_temporal,
                                      MOE: init_moe, DEEP: init_deep}
_MODULES: dict[str, type[nn.Module]] = {LINEAR: LinearEstimator,
                                        MLP: MLPEstimator,
                                        TEMPORAL: TemporalEstimator,
                                        MOE: MoEEstimator,
                                        DEEP: DeepEstimator}


def _learned(mode: str, table: Mapping[str, Any]) -> Any:
    if mode == RATIO:
        raise ValueError("ratio attribution has no learned parameters")
    if mode not in table:
        raise ValueError(f"unknown estimator mode {mode!r}; "
                         f"valid: {RATIO}, {', '.join(table)}")
    return table[mode]


def predictor(mode: str) -> Callable | None:
    """→ ``(params, features, workload_valid) → watts`` for a learned
    mode; None for RATIO (no model to run)."""
    if mode == RATIO:
        return None
    if mode == TEMPORAL:
        raise ValueError(
            "the temporal estimator needs [.., W, T, F] history windows, "
            "not single-tick features — serve it via "
            "models.temporal.predict_temporal (or "
            "parallel.make_temporal_fleet_program) fed by "
            "monitor.HistoryBuffer")
    return _learned(mode, _PREDICTORS)


def initializer(mode: str) -> Callable:
    """→ ``init(n_zones, ..., generator=, device=) → params``."""
    return _learned(mode, _INITIALIZERS)


def estimator_module(mode: str, params: Mapping[str, Any]) -> nn.Module:
    """The learned mode as an ``nn.Module`` over ``params``."""
    return _learned(mode, _MODULES)(dict(params))


def params_from_numpy(mode: str, params: Mapping[str, Any],
                      device: str | torch.device = "cpu") -> dict:
    """The JAX package's params (numpy arrays, or anything ``np.asarray``
    takes; deep's nested ``blocks`` too) → the port's f32 tensors on
    ``device``, keyed the same."""
    _learned(mode, _INITIALIZERS)  # reject ratio and unknown modes
    return params_to(params, device)


def map_params(fn: Callable[[Any], Any], params: Mapping[str, Any]) -> dict:
    """``fn`` over every leaf of ``params``, nesting kept."""
    return {k: (map_params(fn, v) if isinstance(v, Mapping) else fn(v))
            for k, v in params.items()}


def param_leaves(params: Mapping[str, Any]) -> list:
    """Every leaf of ``params`` in sorted key order (nested dicts
    included): the optimizer's and the checkpoint's fixed order."""
    out: list = []
    for k in sorted(params):
        v = params[k]
        out.extend(param_leaves(v) if isinstance(v, Mapping) else [v])
    return out


def params_to(params: Mapping[str, Any],
              device: str | torch.device) -> dict:
    """Params (tensors or arrays, nested dicts kept) → detached f32
    tensors on ``device``: what a serving program takes."""
    return map_params(lambda v: _as_f32(v).to(device), params)


def _as_f32(v: Any) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to(torch.float32)
    return torch.from_numpy(np.array(v, dtype=np.float32))


@dataclass
class ModelEstimator:
    """A trained model and its mode, usable wherever ratio attribution
    is."""

    mode: str
    params: Any

    @classmethod
    def create(cls, mode: str, n_zones: int, seed: int = 0,
               **kwargs: Any) -> "ModelEstimator":
        """Fresh params of ``mode`` drawn from a ``torch.Generator``
        seeded with ``seed`` (the JAX package seeds ``PRNGKey(seed)``;
        the random bits differ)."""
        gen = torch.Generator().manual_seed(seed)
        return cls(mode=mode, params=initializer(mode)(
            n_zones, generator=gen, **kwargs))

    def predict_watts(self, cpu_deltas: torch.Tensor,
                      workload_valid: torch.Tensor,
                      node_cpu_delta: torch.Tensor,
                      usage_ratio: torch.Tensor,
                      dt_s: torch.Tensor) -> torch.Tensor:
        """Features → watts [..., W, Z] (µW = watts · 1e6, by the
        caller)."""
        feats = build_features(cpu_deltas, workload_valid, node_cpu_delta,
                               usage_ratio, dt_s)
        return predictor(self.mode)(self.params, feats, workload_valid)


def save_params(path: str, params: Mapping[str, Any]) -> None:
    """Persist params as ``.npz`` in the JAX package's format: flat keys,
    one level of nesting flattened to "outer/inner", no pickle."""
    flat: dict[str, np.ndarray] = {}
    for k, v in params.items():
        if isinstance(v, Mapping):
            for k2, v2 in v.items():
                flat[f"{k}/{k2}"] = _to_numpy(v2)
        else:
            flat[k] = _to_numpy(v)
    np.savez(path, **flat)


def load_params(path: str, device: str | torch.device = "cpu") -> dict:
    """Load a ``.npz`` written by either package's ``save_params``,
    rebuilding "outer/inner" keys into nested dicts (allow_pickle stays
    off — parameter files may come from untrusted storage)."""
    out: dict = {}
    with np.load(path, allow_pickle=False) as data:
        for k in data.files:
            arr = torch.from_numpy(np.array(data[k])).to(device)
            if "/" in k:
                outer, inner = k.split("/", 1)
                out.setdefault(outer, {})[inner] = arr
            else:
                out[k] = arr
    return out


def _to_numpy(v: Any) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)
