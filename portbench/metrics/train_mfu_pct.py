"""The whole train step's share of the card's bf16 peak: forward and
backward FLOPs (``costs.mlp_train_flops``) of the rows the step computes
on, the window's ``samples ÷ steps`` (the dumps' labelled rows, which
``cmd.train.build_trainer`` gathers once; not every padded slot of the
dumps), × steps, over the traced window's seconds × 989 TFLOP/s, in %."""

from portbench import costs


def read(r):
    steps = r.window.counts.get("steps")
    samples = r.window.counts.get("samples")
    if r.trace is None or not steps or samples is None:
        return None
    est = r.config["estimator"]
    flops = costs.mlp_train_flops(samples // steps, est["n_features"],
                                  est["hidden"], len(r.config["zones"]))
    return 100.0 * flops * steps / (r.trace.window_s * costs.BF16_FLOP_PER_S)
