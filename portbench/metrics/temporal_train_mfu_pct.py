"""The temporal refit's whole train step as a share of the card's bf16
peak: the forward and backward FLOPs of the configuration's shapes
(``train_flops``) over the rows that carry a label, the window's
``samples ÷ steps`` (padding is not model work, though the step computes
on every padded slot), × steps, over the traced window's seconds × 989
TFLOP/s, in %."""

from portbench import costs


def train_flops(rows: int, t: int, f: int, d: int, mlp: int,
                z: int) -> int:
    """FLOPs (2 a multiply-add) of one full-batch step of the temporal
    estimator over ``rows`` windows of ``t`` ticks: the single-query
    forward (``costs.temporal_forward_flops``) and the backward's two
    gradient products of every product, the weight's and the input's,
    but for the features' (the in-projection's and the skip path's
    inputs), which need none. Layer norms, softmax and GELU are not
    counted."""
    per_tick = 2 * (f * d + 4 * d * d)
    per_sequence = 2 * (4 * d * d + 4 * t * d + 4 * d * mlp + 2 * d * z
                        + f * z)
    backward = rows * (t * per_tick + per_sequence)
    return costs.temporal_forward_flops(rows, t, f, d, mlp, z) + backward


def read(r):
    steps = r.window.counts.get("steps")
    samples = r.window.counts.get("samples")
    if r.trace is None or not steps or samples is None:
        return None
    est = r.config["estimator"]
    d = est["d_model"]
    flops = train_flops(samples // steps, r.config["history_window"],
                        est["n_features"], d, est["mlp_ratio"] * d,
                        len(r.config["zones"]))
    return 100.0 * flops * steps / (r.trace.window_s * costs.BF16_FLOP_PER_S)
