"""Estimator registry: the power backends behind one interface.

Modes, as in ``kepler_tpu.models.estimator``:
  "ratio"    — RAPL proportional attribution (no learned parameters)
  "linear"   — linear regression from features
  "mlp"      — MLP from features
  "temporal" — causal attention over feature HISTORY windows
               ([.., W, T, F]; served by ``models.temporal.predict_temporal``
               or ``parallel.make_temporal_fleet_program`` fed by
               ``monitor.HistoryBuffer``, not by :func:`predictor`)
"moe" and "deep" are not ported yet: asking for them raises.

Parameters are plain ``dict[str, Tensor]`` with the JAX package's keys, so
its ``.npz`` parameter files (``save_params``) load here as they are and
:func:`params_from_numpy` carries its in-memory params across.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import numpy as np
import torch
from torch import nn

from kepler_tpu_torch.models.linear import (LinearEstimator, init_linear,
                                            predict_linear)
from kepler_tpu_torch.models.mlp import MLPEstimator, init_mlp, predict_mlp
from kepler_tpu_torch.models.temporal import TemporalEstimator, init_temporal

RATIO = "ratio"
LINEAR = "linear"
MLP = "mlp"
TEMPORAL = "temporal"
NOT_PORTED = ("moe", "deep")

# single-tick predictors: (params, features [.., W, F], workload_valid) →
# watts. TEMPORAL consumes [.., W, T, F] history windows and is not here.
_PREDICTORS: dict[str, Callable] = {LINEAR: predict_linear, MLP: predict_mlp}
_INITIALIZERS: dict[str, Callable] = {LINEAR: init_linear, MLP: init_mlp,
                                      TEMPORAL: init_temporal}
_MODULES: dict[str, type[nn.Module]] = {LINEAR: LinearEstimator,
                                        MLP: MLPEstimator,
                                        TEMPORAL: TemporalEstimator}


def _learned(mode: str, table: Mapping[str, Any]) -> Any:
    if mode in NOT_PORTED:
        raise NotImplementedError(
            f"estimator mode {mode!r} is not yet ported to kepler_tpu_torch;"
            f" ported: {RATIO}, {', '.join(table)}")
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
                      device: str | torch.device = "cpu"
                      ) -> dict[str, torch.Tensor]:
    """The JAX package's params (numpy arrays, or anything ``np.asarray``
    takes) → the port's f32 tensors on ``device``, keyed the same."""
    _learned(mode, _INITIALIZERS)  # reject ratio / unported modes
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
            for k, v in params.items()}


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
