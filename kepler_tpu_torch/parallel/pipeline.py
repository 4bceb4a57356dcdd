"""Pipeline parallelism: GPipe microbatch streaming over ``stage``.

As ``kepler_tpu.parallel.pipeline``: the deep estimator (``models.deep``)
is a stack of S identical residual blocks. The stack's leading axis
shards over the ``stage`` mesh axis (S/n consecutive blocks a shard) and
the batch splits into M microbatches that stream through: each tick
every shard applies its blocks to the activation it holds, then
``collectives.ppermute`` hands the result one hop down the ring. After
``M + n − 1`` ticks every microbatch has crossed every stage (GPipe,
with its n − 1 tick bubble). Stage 0 takes microbatch t at tick t, and
the last stage writes microbatch ``t − (n − 1)``.

Where the JAX program computes every stage at every tick (the bubble
computes on zeros or on a repeated microbatch and is masked at the
write), a shard computes here only at the ticks whose result is read:
the same outputs, without the bubble's work. Inference only, as in JAX.

On a mesh of several processes each rank runs the ticks for its own
stages (stage 0's rank feeds the microbatches), the hops between two
ranks' stages cross through ``torch.distributed``, and every rank still
calls the hop at every tick. The last stage's rank then holds the whole
output, and one ``collectives.broadcast`` hands it to every rank (JAX
replicates it with a masked ``psum``, n slots of traffic).
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from kepler_tpu_torch.parallel.collectives import (axis_devices, broadcast,
                                                   crosses, local_indices,
                                                   local_map, ppermute)
from kepler_tpu_torch.parallel.mesh import Mesh

STAGE_AXIS = "stage"


def stage_slices(stacked: dict[str, torch.Tensor],
                 devices: list[torch.device]) -> list[dict[str, torch.Tensor]]:
    """Stacked ``[S, ...]`` stage params → shard ``i``'s consecutive S/n
    blocks on its device (None at other ranks' shards). Raises
    ValueError when S does not divide by n."""
    n = len(devices)
    s = next(iter(stacked.values())).shape[0]
    if s % n:
        raise ValueError(f"{s} stages do not divide over {n} shards")
    per = s // n
    return local_map(devices, lambda i: {
        k: v[i * per:(i + 1) * per].to(devices[i])
        for k, v in stacked.items()})


def _gpipe(shards, x_mb, *, devices, stage_fn):
    """The tick loop over microbatches ``x_mb [M, mB, ...]`` → the last
    stage's outputs, microbatch by microbatch (on the last stage's rank;
    None on the others)."""
    n, m = len(devices), x_mb.shape[0]

    def apply_local(params, x):
        # a shard may own several consecutive blocks of the stack
        for j in range(next(iter(params.values())).shape[0]):
            x = stage_fn({k: v[j] for k, v in params.items()}, x)
        return x

    state: list[torch.Tensor | None] = [None] * n
    out: list[torch.Tensor | None] = [None] * m
    for t in range(m + n - 1):
        ys: list[torch.Tensor | None] = [None] * n
        for idx in local_indices(devices):
            if not 0 <= t - idx < m:  # the bubble: nothing to read
                continue
            x_in = x_mb[t].to(devices[0]) if idx == 0 else state[idx]
            ys[idx] = apply_local(shards[idx], x_in)
        if t >= n - 1:
            out[t - (n - 1)] = ys[n - 1]
        # every rank hops at every tick; the last stage's hop back to
        # stage 0 is never read
        state = ppermute(ys[:n - 1] + [None], devices)
    return out


def make_pipeline(
    mesh: Mesh,
    stage_fn: Callable,  # (block params without the stage axis, x) → x
    *,
    axis_name: str = STAGE_AXIS,
    n_microbatches: int = 4,
) -> Callable:
    """→ ``(stacked_stage_params, x [B, D]) → [B, D]``.

    ``stacked_stage_params``: a dict of tensors with a leading stage axis
    S (divisible by the ``axis_name`` mesh size). ``B`` must divide by
    ``n_microbatches``. The output equals applying the S stages in
    order; it lies on the first shard's device (on a mesh of several
    processes, every rank passes the same whole inputs and gets the
    whole output on its first shard's device).
    """
    devices = axis_devices(mesh, axis_name)
    last = len(devices) - 1

    def fn(stage_params, x):
        b = x.shape[0]
        if b % n_microbatches:
            raise ValueError(
                f"batch {b} not divisible by {n_microbatches} microbatches")
        x_mb = x.reshape(n_microbatches, b // n_microbatches, *x.shape[1:])
        out = _gpipe(stage_slices(stage_params, devices), x_mb,
                     devices=devices, stage_fn=stage_fn)
        if not crosses(devices):
            return torch.cat([o.to(devices[0]) for o in out]).reshape(
                x.shape)
        whole = local_map(devices, lambda i: torch.cat(out).reshape(
            x.shape) if i == last else None)
        return broadcast(whole, devices, last)[local_indices(devices)[0]]

    return fn


def make_pipelined_deep(
    mesh: Mesh,
    *,
    axis_name: str = STAGE_AXIS,
    n_microbatches: int = 4,
    clamp: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> Callable:
    """→ ``(params, features [B, F], workload_valid [B]) → watts [B, Z]``.

    Embed and head run outside the pipeline on the first shard's device
    (one small product each; across processes every rank runs both, so
    every rank returns the whole watts); the block stack streams through
    the stage ring."""
    from kepler_tpu_torch.models.deep import block_fn, embed, head

    pipeline = make_pipeline(
        mesh, functools.partial(block_fn, compute_dtype=compute_dtype),
        axis_name=axis_name, n_microbatches=n_microbatches)

    def fn(params, features, workload_valid):
        x = embed(params, features, compute_dtype)
        x = pipeline(params["blocks"], x)
        return head(params, x, workload_valid, clamp, features=features)

    return fn
