"""Ring attention: context parallelism over the history time axis.

As ``kepler_tpu.parallel.ring``: a temporal estimator's fleet window is
``[B, T, F]`` with T up to hours of ticks, so the sequence axis shards
over the ``seq`` mesh axis and attention runs as a ring. Each shard keeps
its query block and rotates the K/V blocks around the axis one hop a
step (``collectives.ppermute``), folding flash-attention partials with
the online-softmax merge (``ops.attention``). No shard forms the
``[T, T]`` scores or holds the whole K/V sequence, and after n steps the
merge equals exact softmax attention.

The JAX ring is one ``shard_map`` program; here each process drives
each of its own shards of the mesh in turn (virtual shards may share a
device), and the KV hops between two processes' shards go through
``torch.distributed`` (``parallel.collectives``). Every rank runs the
same schedule, the skipped last hop included.
:func:`ring_blocks` is the block core: it takes each shard's contiguous
``T/n`` block of q, k, v and ``t_valid`` on its device and returns each
shard's output block there. The sequence-parallel programs
(``parallel.sequence``) call it between their per-shard trunk halves.
The whole-tensor forms (:func:`ring_attention_shardmap`,
:func:`make_ring_attention`) cut whole ``[B, T, H, D]`` tensors into the
blocks (:func:`split_blocks`), run the core and join the output on the
first shard's device (on a mesh of several processes every rank gets
it, by an ``all_gather``, on its first shard's device:
``collectives.gather_whole``). ``backend="pallas"``
computes every block partial with kernel B3
(``ops.cuda_attention.flash_block_pallas``, scalar block starts, the
causal mask rebuilt inside the kernel): n² launches a call on CUDA
tensors. B3 has no backward, so gradients take the default ``"einsum"``
backend, as the JAX sequence-parallel trainer does.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from kepler_tpu_torch.ops import cuda_attention
from kepler_tpu_torch.ops.attention import (_NEG_INF, block_attn,
                                            full_attention, merge_blocks,
                                            stats_to_out)
from kepler_tpu_torch.parallel.collectives import (axis_devices,
                                                   gather_whole,
                                                   local_indices, local_map,
                                                   ppermute)
from kepler_tpu_torch.parallel.mesh import Mesh

SEQ_AXIS = "seq"

__all__ = ["SEQ_AXIS", "full_attention", "join_blocks",
           "make_ring_attention", "ring_attention_shardmap", "ring_blocks",
           "split_blocks"]

Attention = Callable[[torch.Tensor, torch.Tensor, torch.Tensor,
                      torch.Tensor], torch.Tensor]


def split_blocks(x: torch.Tensor, devices: list[torch.device]
                 ) -> list[torch.Tensor]:
    """``x [B, T, ...]`` → n contiguous blocks of T/n, block ``i`` on
    ``devices[i]`` (None at other ranks' shards). Raises ValueError when
    T does not divide by n."""
    n = len(devices)
    if x.shape[1] % n:
        raise ValueError(f"T = {x.shape[1]} does not divide by the "
                         f"{n} shards of the axis")
    blocks = torch.chunk(x, n, dim=1)
    return local_map(devices,
                     lambda i: blocks[i].to(devices[i]).contiguous())


def join_blocks(blocks: list[torch.Tensor], device: torch.device
                ) -> torch.Tensor:
    """Per-shard blocks ``[B, T/n, ...]`` → the whole ``[B, T, ...]`` on
    ``device``, in shard order."""
    return torch.cat([x.to(device) for x in blocks], dim=1)


def ring_blocks(qs: list[torch.Tensor], ks: list[torch.Tensor],
                vs: list[torch.Tensor], vals: list[torch.Tensor], *,
                devices: list[torch.device], causal: bool = True,
                compute_dtype: torch.dtype = torch.bfloat16,
                backend: str = "einsum") -> list[torch.Tensor]:
    """The ring over per-shard blocks: shard ``i`` holds the ``T/n``
    ticks from ``i · T/n`` of q, k, v ``[B, T/n, H, D]`` and ``t_valid``
    ``[B, T/n]`` on ``devices[i]`` → its output block there, in q's
    dtype. The block core of every ring form: nothing is split or
    joined here. Each rank computes its own shards' blocks (the others'
    slots are None)."""
    if backend not in ("einsum", "pallas"):
        raise ValueError(f"unknown ring backend {backend!r}")
    n = len(devices)
    mine = local_indices(devices)
    b, t_loc, h, d = qs[mine[0]].shape
    scale = 1.0 / math.sqrt(d)

    def partials(i, src):
        """Shard ``i``'s query block against the KV block of shard
        ``src`` that it holds now."""
        if backend == "pallas":
            return cuda_attention.flash_block_pallas(
                qs[i], ks[i], vs[i], vals[i], i * t_loc, src * t_loc,
                causal=causal, compute_dtype=compute_dtype)
        dev = devices[i]
        mask = vals[i][:, None, None, :]
        if causal:
            q_pos = i * t_loc + torch.arange(t_loc, device=dev)
            kv_pos = src * t_loc + torch.arange(t_loc, device=dev)
            mask = mask & (q_pos[:, None] >= kv_pos[None, :])
        return block_attn(qs[i], ks[i], vs[i], mask, scale, compute_dtype)

    f32 = torch.float32
    o = local_map(devices, lambda i: torch.zeros(
        (b, t_loc, h, d), dtype=f32, device=devices[i]))
    m = local_map(devices, lambda i: torch.full(
        (b, h, t_loc), _NEG_INF, dtype=f32, device=devices[i]))
    l = local_map(devices, lambda i: torch.zeros(  # noqa: E741
        (b, h, t_loc), dtype=f32, device=devices[i]))
    for s in range(n):
        for i in mine:
            pv, m_blk, l_blk = partials(i, (i - s) % n)
            o[i], m[i], l[i] = merge_blocks(o[i], m[i], l[i], pv, m_blk,
                                            l_blk)
        if s < n - 1:  # JAX's last hop only brings each block home
            ks, vs, vals = (ppermute(x, devices) for x in (ks, vs, vals))
    return local_map(devices, lambda i: (o[i] / stats_to_out(
        torch.clamp(l[i], min=1e-30))).to(qs[i].dtype))


def _ring(q, k, v, t_valid, *, devices, causal, compute_dtype, backend):
    """The n shards' ring over whole tensors → the whole output:
    split, :func:`ring_blocks`, gather."""
    qs, ks, vs, vals = (split_blocks(x, devices) for x in (q, k, v, t_valid))
    out = ring_blocks(qs, ks, vs, vals, devices=devices, causal=causal,
                      compute_dtype=compute_dtype, backend=backend)
    return gather_whole(out, devices, axis=1)


def ring_attention_shardmap(
    mesh: Mesh,
    *,
    axis_name: str = SEQ_AXIS,
    causal: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
    backend: str = "einsum",
) -> Attention:
    """→ ``(q, k, v, t_valid) → out`` over the ``axis_name`` shards of
    ``mesh``: the composable form, an ``attention_fn`` for the temporal
    trunk's seam (the sequence-parallel programs pass it)."""
    if backend not in ("einsum", "pallas"):
        raise ValueError(f"unknown ring backend {backend!r}")
    devices = axis_devices(mesh, axis_name)

    def ring(q, k, v, t_valid):
        return _ring(q, k, v, t_valid, devices=devices, causal=causal,
                     compute_dtype=compute_dtype, backend=backend)

    return ring


def make_ring_attention(
    mesh: Mesh,
    *,
    axis_name: str = SEQ_AXIS,
    causal: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
    backend: str = "einsum",
) -> Attention:
    """→ ``(q, k, v, t_valid) → out`` with T sharded over the mesh.

    Inputs are ``[B, T, H, D]`` (+ ``t_valid`` bool ``[B, T]``); T must
    divide by the ``axis_name`` mesh size. The output is whole, on the
    first shard's device (on a mesh of several processes, every rank
    passes the same whole inputs and gets the whole output on its first
    shard's device). ``backend="pallas"`` computes each block partial
    with kernel B3; "einsum" with ``ops.attention.block_attn``.
    """
    return ring_attention_shardmap(mesh, axis_name=axis_name, causal=causal,
                                   compute_dtype=compute_dtype,
                                   backend=backend)
