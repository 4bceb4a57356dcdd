"""Ulysses-style (all-to-all) sequence parallelism for attention.

As ``kepler_tpu.parallel.ulysses``, the second context-parallel scheme
beside the ring: one ``all_to_all`` turns the sharded sequence axis into
a sharded head axis, each shard runs ordinary dense attention over the
whole sequence for its heads (``ops.attention.full_attention``, no
kernel, as in JAX), and a second ``all_to_all`` restores sequence
sharding (DeepSpeed-Ulysses). Its degree is capped by the head count (H
must divide by the axis size); the ring scales to any divisor of T. Both
plug into the temporal trunk's ``attention_fn`` seam.

:func:`ulysses_blocks` is the block core, with ``ring.ring_blocks``'
contract: per-shard ``T/n`` blocks in, per-shard output blocks out. The
whole-tensor forms cut T into one block per shard and join the output
on the first shard's device; the temporal program runs its trunk per
shard block around the core (``parallel.sequence``). On a mesh of
several processes each rank attends for its own shards' heads, and the
all-to-alls and the all-gather cross ranks (``parallel.collectives``).
"""

from __future__ import annotations

from typing import Callable

import torch

from kepler_tpu_torch.ops.attention import full_attention
from kepler_tpu_torch.parallel.collectives import (all_gather, all_to_all,
                                                   axis_devices, gather_whole,
                                                   local_map)
from kepler_tpu_torch.parallel.mesh import Mesh
from kepler_tpu_torch.parallel.ring import SEQ_AXIS, Attention, split_blocks
from kepler_tpu_torch.parallel.sequence import make_sharded_temporal_program


def ulysses_blocks(qs: list[torch.Tensor], ks: list[torch.Tensor],
                   vs: list[torch.Tensor], tvs: list[torch.Tensor], *,
                   devices: list[torch.device], causal: bool = True,
                   compute_dtype: torch.dtype = torch.bfloat16
                   ) -> list[torch.Tensor]:
    """Ulysses over per-shard blocks, the contract of
    ``ring.ring_blocks``: shard ``i``'s ``T/n`` ticks of q, k, v
    ``[B, T/n, H, D]`` and ``t_valid`` on ``devices[i]`` → its output
    block there. H must divide by n."""
    # time-gather / head-scatter: [B, T/P, H, Dh] → [B, T, H/P, Dh]
    qg, kg, vg = (all_to_all(x, devices, split_axis=2, concat_axis=1)
                  for x in (qs, ks, vs))
    tv = all_gather(tvs, devices, axis=1)  # [B, T] on every shard
    outs = local_map(devices, lambda i: full_attention(
        qg[i], kg[i], vg[i], causal=causal, t_valid=tv[i],
        compute_dtype=compute_dtype))
    # head-gather / time-scatter back: [B, T, H/P, Dh] → [B, T/P, H, Dh]
    return all_to_all(outs, devices, split_axis=1, concat_axis=2)


def _heads_divide(h: int, n: int, axis_name: str) -> None:
    if h % n:
        raise ValueError(
            f"Ulysses needs heads ({h}) divisible by the '{axis_name}' "
            f"mesh size ({n}); use the ring for more parallelism than "
            "heads")


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
        _heads_divide(q.shape[2], n, axis_name)
        blocks = (split_blocks(x, devices) for x in (q, k, v, t_valid))
        return gather_whole(ulysses_blocks(*blocks, devices=devices,
                                           causal=causal,
                                           compute_dtype=compute_dtype),
                            devices, axis=1)

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
    the all-to-all twin of ``sequence.make_temporal_program``: the trunk
    per shard block, attention as :func:`ulysses_blocks`."""
    devices = axis_devices(mesh, axis_name)
    n = len(devices)

    def core(qs, ks, vs, tvs):
        _heads_divide(next(q for q in qs if q is not None).shape[2], n,
                      axis_name)
        return ulysses_blocks(qs, ks, vs, tvs, devices=devices, causal=True,
                              compute_dtype=compute_dtype)

    return make_sharded_temporal_program(devices, core, clamp=clamp,
                                         compute_dtype=compute_dtype)
