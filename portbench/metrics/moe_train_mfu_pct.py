"""The mixture-of-experts refit's whole train step as a share of the
card's bf16 peak: the forward and backward FLOPs of the configuration's
shapes (``train_flops``) over the rows the step computes on, the
window's ``samples ÷ steps`` (the dumps' labelled rows), × steps, over
the traced window's seconds × 989 TFLOP/s, in %."""

from portbench import costs


def train_flops(rows: int, e: int, f: int, h: int, z: int) -> int:
    """FLOPs (2 a multiply-add) of one full-batch step of the mixture
    over ``rows`` feature rows, every one through all ``e`` experts:
    the forward's expert products (``f → h → z`` and the ``f → z`` skip
    path), the gate's ``f → e`` product and the ``e``-way combine of
    ``z`` outputs; the backward's two gradient products of every product,
    the weight's and the input's, but for those whose input is the
    features (the first layer's, the skip path's and the gate's), which
    need the weight's alone, and the combine's two (the experts' outputs'
    and the gates'). Softmax, GELU and the bias adds are not counted."""
    forward = e * 2 * (f * h + h * z + f * z) + 2 * f * e + 2 * e * z
    backward = e * 2 * (f * h + 2 * h * z + f * z) + 2 * f * e + 4 * e * z
    return rows * (forward + backward)


def read(r):
    steps = r.window.counts.get("steps")
    samples = r.window.counts.get("samples")
    if r.trace is None or not steps or samples is None:
        return None
    est = r.config["estimator"]
    flops = train_flops(samples // steps, est["n_experts"],
                        est["n_features"], est["hidden"],
                        len(r.config["zones"]))
    return 100.0 * flops * steps / (r.trace.window_s * costs.BF16_FLOP_PER_S)
