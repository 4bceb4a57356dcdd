"""The whole window's share of the card's bf16 peak: the temporal
estimator's forward FLOPs at the configuration's padded shapes
(``costs.temporal_forward_flops``) × windows, over the traced window's
seconds × 989 TFLOP/s, in %."""

from portbench import costs, fleetgen


def read(r):
    windows = r.window.counts.get("windows")
    if r.trace is None or not windows:
        return None
    fleet = fleetgen.Fleet.of(r.config)
    est = r.config["estimator"]
    flops = costs.temporal_forward_flops(
        fleet.n * fleet.w, fleet.history, est["n_features"], est["d_model"],
        est["mlp_ratio"] * est["d_model"], fleet.zones)
    return 100.0 * flops * windows / (r.trace.window_s
                                      * costs.BF16_FLOP_PER_S)
