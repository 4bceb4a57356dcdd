"""Blockwise attention primitives (flash-style online softmax).

Plain PyTorch, as ``kepler_tpu.ops.attention``: the temporal estimator's
dense attention and the reference arithmetic of kernel B3
(``ops.cuda_attention``). The online-softmax merge makes attention
computable one KV block at a time:

    m_new = max(m, rowmax(scores))
    o     = o * e^(m - m_new) + e^(scores - m_new) @ V
    l     = l * e^(m - m_new) + rowsum(e^(scores - m_new))

Products take operands rounded to the caller's compute dtype (bf16 by
default) and accumulate in f32; softmax statistics stay f32.
"""

from __future__ import annotations

import math

import torch

_NEG_INF = -1e30  # large-but-finite: keeps exp() exactly 0 without NaN risk


def round_to(x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``compute_dtype`` and held in f32 (a no-op for
    f32): the operand of a half-operand, f32-accumulator product on its
    plain route (the CPU, f16, f32, a contracted width that is no
    multiple of 8; ``models.nn.acc_matmul``) and in B3's plain attention.
    Its backward rounds the f32 gradient to ``compute_dtype`` the same
    way. On the card at bf16 the products cast each operand once instead
    and keep that backward (``models.nn.HalfProduct``)."""
    if compute_dtype == torch.float32:
        return x
    return x.to(compute_dtype).to(torch.float32)


def block_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: torch.Tensor, scale: float,
               compute_dtype: torch.dtype
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scores for one (q-block, kv-block) pair → (p @ v, rowmax, rowsum).

    q [B, Tq, H, D] × k [B, Tk, H, D] → scores [B, H, Tq, Tk]; ``mask``
    broadcasts against the scores. f32 softmax statistics regardless of
    the compute dtype.
    """
    s = torch.einsum("bqhd,bkhd->bhqk", round_to(q, compute_dtype),
                     round_to(k, compute_dtype)) * scale
    s = torch.where(mask, s, _NEG_INF)
    m = torch.amax(s, dim=-1)  # [B, H, Tq]
    p = torch.exp(s - m[..., None])
    p = torch.where(mask, p, 0.0)  # fully-masked rows: force exact 0
    l = torch.sum(p, dim=-1)  # [B, H, Tq]
    pv = torch.einsum("bhqk,bkhd->bqhd", round_to(p, compute_dtype),
                      round_to(v, compute_dtype))
    return pv, m, l


def merge_blocks(o, m, l, pv, m_blk, l_blk):
    """Fold one block's partials into the running online-softmax state."""
    m_new = torch.maximum(m, m_blk)
    corr_old = torch.exp(m - m_new)
    corr_blk = torch.exp(m_blk - m_new)
    o = o * stats_to_out(corr_old) + pv * stats_to_out(corr_blk)
    l_new = l * corr_old + l_blk * corr_blk
    return o, m_new, l_new


def stats_to_out(x: torch.Tensor) -> torch.Tensor:
    """[B, H, Tq] softmax stats → [B, Tq, H, 1] for scaling o."""
    return torch.movedim(x, -2, -1)[..., None]


def full_attention(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    t_valid: torch.Tensor | None = None,  # bool [B, T] keys to attend to
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Dense single-device attention; also the serving path for short T."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    tq, tk = q.shape[1], k.shape[1]
    mask = torch.ones((1, 1, tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        pos_q = torch.arange(tq, device=q.device)
        pos_k = torch.arange(tk, device=q.device)
        mask = mask & (pos_q[:, None] >= pos_k[None, :])
    if t_valid is not None:
        mask = mask & t_valid[:, None, None, :]
    pv, _, l = block_attn(q, k, v, mask, scale, compute_dtype)
    l_safe = torch.clamp(l, min=1e-30)
    return (pv / stats_to_out(l_safe)).to(q.dtype)
