"""Sequence/context parallelism for the temporal estimator.

As ``kepler_tpu.parallel.sequence``: long feature-history windows
(``models.temporal``) shard their time axis over the ``seq`` mesh axis.
Attention, the only cross-timestep op, runs as the ring
(``parallel.ring``), so no shard holds the whole K/V sequence. The
per-timestep trunk ops (in-projection, layer norms, MLP, head) run on
the whole tensor on the first shard's device, where JAX shards them by
sharding annotations; the ring moves each shard's blocks to its device.
Params are replicated (the model is small: the memory is in the
sequence).
"""

from __future__ import annotations

from typing import Callable

import torch

from kepler_tpu_torch.models.temporal import predict_temporal
from kepler_tpu_torch.models.train import Optimizer, temporal_step_fn
from kepler_tpu_torch.parallel.mesh import Mesh
from kepler_tpu_torch.parallel.ring import SEQ_AXIS, ring_attention_shardmap


def make_temporal_program(
    mesh: Mesh,
    *,
    axis_name: str = SEQ_AXIS,
    clamp: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> Callable:
    """→ ``(params, feat_hist [W, T, F], workload_valid [W],
    t_valid [W, T]) → watts [W, Z]`` with attention's T sharded over
    ``axis_name`` (T must divide by its size): the full trunk through the
    ring, with JAX's default einsum backend."""
    ring = ring_attention_shardmap(mesh, axis_name=axis_name, causal=True,
                                   compute_dtype=compute_dtype)

    def fn(params, feat_hist, workload_valid, t_valid):
        return predict_temporal(params, feat_hist, workload_valid, t_valid,
                                clamp=clamp, compute_dtype=compute_dtype,
                                attention_fn=ring)

    return fn


def make_sequence_parallel_train_step(
    mesh: Mesh,
    optimizer: Optimizer | None = None,
    *,
    axis_name: str = SEQ_AXIS,
    compute_dtype: torch.dtype = torch.float32,
    remat: bool = False,
) -> Callable:
    """Long-context training: gradients flow back through the ring.

    → ``(state, feat_hist [W, T, F], workload_valid [W], t_valid [W, T],
    target_watts [W, Z]) → (state, loss)``. The body is
    ``models.train.temporal_step_fn`` with the ring as its
    ``attention_fn``; autograd reverses the KV ring (the transpose of a
    ring shift is the opposite shift). ``remat=True`` recomputes the
    forward's activations in the backward (``torch.utils.checkpoint``).
    As the port's other train steps, the step updates the state's
    tensors in place (JAX donates the state).
    """
    ring = ring_attention_shardmap(mesh, axis_name=axis_name, causal=True,
                                   compute_dtype=compute_dtype)
    return temporal_step_fn(optimizer, compute_dtype, attention_fn=ring,
                            remat=remat)
