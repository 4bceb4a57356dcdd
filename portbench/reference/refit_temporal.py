"""The temporal family's plain refit, as the refit driver finds it for a
configuration whose ``model`` is ``temporal`` (the three names
``refit_mlp`` sets out).

The forward is ``temporal.watts``'s block, written out again here with
two departures for a refit: the loss reads the **unclamped** output
(``cmd.train``'s loss does, so that the serve-time floor cannot zero
the gradients), and every row it is given is a labelled workload (no
``valid`` mask on the output; the loss's mask keeps the labelled zones).
The loss is the mean squared error in watts over the labelled
(workload, zone) entries; its gradient is autograd's over these plain
ops, with every product's operands rounded by ``rnd`` (the stated
``compute_dtype``) and summed in f32 with TF32 off.

The start is ``cmd.train``'s: the widths it builds (``D_MODEL``,
``temporal.N_HEADS`` heads, an MLP of ``MLP_RATIO`` × ``D_MODEL``,
``max(T, T_MIN)`` learned positions), drawn from a CPU
``torch.Generator`` seeded with the job's seed in the initialiser's
order: Glorot-normal (N(0, 2 / (fan_in + fan_out))) ``in_proj``,
N(0, 0.02²) ``pos_emb``, Glorot-normal ``wq``, ``wk``, ``wv``, ``wo``,
``w_mlp0`` and ``w_mlp1``; layer norms start at one, biases and the head
and skip path at zero. Of the configuration it reads the zones, the
features and ``history_window`` alone: ``cmd.train`` has no flag for the
widths.
"""

from __future__ import annotations

import math
from typing import Any, Mapping

import torch

from portbench.reference.adamw import Params
from portbench.reference.precision import Rounding, exact_f32
from portbench.reference.temporal import N_HEADS, gelu_tanh, layer_norm

D_MODEL = 128
MLP_RATIO = 4
T_MIN = 128
# rows a block of the loss and its gradient takes at a time: the
# reference's memory, not its result (each row's output reads only its
# own history, so the blocks' sums add up to the whole batch's)
BLOCK_ROWS = 16384


def start(seed: int, config: Mapping[str, Any]) -> Params:
    """The refit's starting params (CPU, f32) for ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    f = config["estimator"]["n_features"]
    z = len(config["zones"])
    d, d4 = D_MODEL, MLP_RATIO * D_MODEL

    def glorot(shape: tuple[int, int]) -> torch.Tensor:
        return (torch.randn(shape, generator=gen, dtype=torch.float32)
                * math.sqrt(2.0 / (shape[0] + shape[1])))

    p = {"in_proj": glorot((f, d))}
    p["pos_emb"] = torch.randn(
        (max(config["history_window"], T_MIN), d), generator=gen,
        dtype=torch.float32) * 0.02
    for name in ("wq", "wk", "wv", "wo"):
        p[name] = glorot((d, d))
    p["w_mlp0"] = glorot((d, d4))
    p["w_mlp1"] = glorot((d4, d))
    ones, zeros = torch.ones, torch.zeros
    for ln in ("ln1", "ln2", "ln_f"):
        p[f"{ln}_scale"], p[f"{ln}_bias"] = ones(d), zeros(d)
    p.update(b_mlp0=zeros(d4), b_mlp1=zeros(d), w_head=zeros((d, z)),
             b_head=zeros(z), w_skip=zeros((f, z)))
    return p


def inputs(dumps: Mapping[str, Any], device: torch.device
           ) -> tuple[torch.Tensor, ...]:
    """(feat_hist [R, T, F], t_valid [R, T], workload_valid [R],
    target_watts [R, Z], label_valid [R, Z]) of the dumps' rows that carry
    a label (a slot with a label in some zone; the others add nothing to
    the loss or its gradient)."""
    keep = dumps["label_valid"].any(-1)

    def put(key: str) -> torch.Tensor:
        return torch.from_numpy(dumps[key][keep]).to(device)

    return (put("feat_hist"), put("t_valid"), put("workload_valid"),
            put("target_watts"), put("label_valid"))


def forward(p: Mapping[str, torch.Tensor], feat: torch.Tensor,
            t_valid: torch.Tensor, rnd: Rounding) -> torch.Tensor:
    """Unclamped watts [B, Z] of histories ``feat`` [B, T, F]."""
    b, t, _ = feat.shape
    dh = D_MODEL // N_HEADS

    def mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return rnd(a) @ rnd(w)

    x = mm(feat, p["in_proj"]) + p["pos_emb"][:t]
    x = torch.where(t_valid[..., None], x, 0.0)
    last = (t_valid.sum(dim=-1) - 1).clamp(min=0)
    rows = torch.arange(b, device=feat.device)
    y = layer_norm(x, p["ln1_scale"], p["ln1_bias"])
    q = mm(y[rows, last], p["wq"]).reshape(b, N_HEADS, dh)
    k = mm(y, p["wk"]).reshape(b, t, N_HEADS, dh)
    v = mm(y, p["wv"]).reshape(b, t, N_HEADS, dh)
    scores = torch.einsum("bhd,bthd->bht", rnd(q), rnd(k)) / math.sqrt(dh)
    seen = t_valid & (torch.arange(t, device=feat.device)[None]
                      <= last[:, None])
    scores = torch.where(seen[:, None, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(t_valid.any(dim=-1)[:, None, None], probs, 0.0)
    attn = torch.einsum("bht,bthd->bhd", rnd(probs), rnd(v)).reshape(
        b, D_MODEL)
    h = x[rows, last] + mm(attn, p["wo"])
    hidden = gelu_tanh(mm(layer_norm(h, p["ln2_scale"], p["ln2_bias"]),
                          p["w_mlp0"]) + p["b_mlp0"])
    h = h + mm(hidden, p["w_mlp1"]) + p["b_mlp1"]
    h = layer_norm(h, p["ln_f_scale"], p["ln_f_bias"])
    return h @ p["w_head"] + feat[rows, last] @ p["w_skip"] + p["b_head"]


def loss_and_grad(p: Params, feat: torch.Tensor,  # [R, T, F]
                  t_valid: torch.Tensor,  # bool [R, T]
                  valid: torch.Tensor,  # bool [R]
                  targets: torch.Tensor,  # [R, Z]
                  label_valid: torch.Tensor,  # bool [R, Z]
                  rnd: Rounding) -> tuple[float, Params]:
    """The masked MSE and its gradient over every row, ``BLOCK_ROWS``
    rows at a time."""
    mask = valid[:, None] & label_valid
    count = mask.sum().to(torch.float32).clamp(min=1.0)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in p.items()}
    total = 0.0
    with exact_f32():
        for lo in range(0, feat.shape[0], BLOCK_ROWS):
            sl = slice(lo, lo + BLOCK_ROWS)
            err = (forward(leaves, feat[sl], t_valid[sl], rnd)
                   - targets[sl]) ** 2
            part = torch.where(mask[sl], err, 0.0).sum() / count
            part.backward()
            total += float(part.detach())
    return total, {k: v.grad.detach() for k, v in leaves.items()}
