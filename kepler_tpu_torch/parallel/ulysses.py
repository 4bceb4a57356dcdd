"""Ulysses-style (all-to-all) sequence parallelism for attention.

As ``kepler_tpu.parallel.ulysses``, the second context-parallel scheme
beside the ring: one ``all_to_all`` turns the sharded sequence axis into
a sharded head axis, each shard runs ordinary dense attention over the
whole sequence for its heads (``ops.attention.full_attention``, no
kernel, as in JAX), and a second ``all_to_all`` restores sequence
sharding (DeepSpeed-Ulysses). Its degree is capped by the head count (H
must divide by the axis size); the ring scales to any divisor of T. Both
plug into the temporal trunk's ``attention_fn`` seam.

Inputs and outputs are whole tensors, as ``parallel.ring``'s: T is cut
into one block per shard, and the output is joined on the first
shard's device.
"""

from __future__ import annotations

from typing import Callable

import torch

from kepler_tpu_torch.ops.attention import full_attention
from kepler_tpu_torch.parallel.collectives import (all_gather, all_to_all,
                                                   axis_devices)
from kepler_tpu_torch.parallel.mesh import Mesh
from kepler_tpu_torch.parallel.ring import SEQ_AXIS, Attention, split_blocks


def _ulysses(q, k, v, t_valid, *, devices, causal, compute_dtype):
    qs, ks, vs, tvs = (split_blocks(x, devices) for x in (q, k, v, t_valid))
    # time-gather / head-scatter: [B, T/P, H, Dh] → [B, T, H/P, Dh]
    qg, kg, vg = (all_to_all(x, devices, split_axis=2, concat_axis=1)
                  for x in (qs, ks, vs))
    tv = all_gather(tvs, devices, axis=1)  # [B, T] on every shard
    outs = [full_attention(a, b, c, causal=causal, t_valid=m,
                           compute_dtype=compute_dtype)
            for a, b, c, m in zip(qg, kg, vg, tv)]
    # head-gather / time-scatter back: [B, T, H/P, Dh] → [B, T/P, H, Dh]
    back = all_to_all(outs, devices, split_axis=1, concat_axis=2)
    return torch.cat([x.to(devices[0]) for x in back], dim=1)


def ulysses_attention_shardmap(
    mesh: Mesh,
    *,
    axis_name: str = SEQ_AXIS,
    causal: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> Attention:
    """→ ``(q, k, v, t_valid) → out`` over the ``axis_name`` shards of
    ``mesh`` (the contract of ``ring.ring_attention_shardmap``); H must
    divide by the axis size, else the call raises ValueError."""
    devices = axis_devices(mesh, axis_name)
    n = len(devices)

    def checked(q, k, v, t_valid):
        if q.shape[2] % n:
            raise ValueError(
                f"Ulysses needs heads ({q.shape[2]}) divisible by the "
                f"'{axis_name}' mesh size ({n}); use the ring for more "
                "parallelism than heads")
        return _ulysses(q, k, v, t_valid, devices=devices, causal=causal,
                        compute_dtype=compute_dtype)

    return checked


def make_ulysses_attention(
    mesh: Mesh,
    *,
    axis_name: str = SEQ_AXIS,
    causal: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> Attention:
    """→ ``(q, k, v, t_valid) → out`` with T sharded over the mesh and
    the heads re-partitioned by ``all_to_all``."""
    return ulysses_attention_shardmap(mesh, axis_name=axis_name,
                                      causal=causal,
                                      compute_dtype=compute_dtype)


def make_ulysses_temporal_program(
    mesh: Mesh,
    *,
    axis_name: str = SEQ_AXIS,
    clamp: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> Callable:
    """The temporal estimator served with Ulysses context parallelism,
    the all-to-all twin of ``sequence.make_temporal_program``."""
    from kepler_tpu_torch.models.temporal import predict_temporal

    attn = ulysses_attention_shardmap(mesh, axis_name=axis_name,
                                      causal=True,
                                      compute_dtype=compute_dtype)

    def fn(params, feat_hist, workload_valid, t_valid):
        return predict_temporal(params, feat_hist, workload_valid, t_valid,
                                clamp=clamp, compute_dtype=compute_dtype,
                                attention_fn=attn)

    return fn
