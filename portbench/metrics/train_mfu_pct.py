"""The whole train step's share of the card's bf16 peak: forward and
backward FLOPs of every feature row of the dumps (RAPL rows × padded
workload slots; ``costs.mlp_train_flops``) × steps, over the traced
window's seconds × 989 TFLOP/s, in %."""

from portbench import costs, fleetgen


def read(r):
    steps = r.window.counts.get("steps")
    if r.trace is None or not steps:
        return None
    fleet = fleetgen.Fleet.of(r.config)
    rapl_nodes = fleet.nodes - int(fleet.model_nodes().sum())
    rows = r.config["dump_windows"] * rapl_nodes * fleet.w
    est = r.config["estimator"]
    flops = costs.mlp_train_flops(rows, est["n_features"], est["hidden"],
                                  fleet.zones)
    return 100.0 * flops * steps / (r.trace.window_s * costs.BF16_FLOP_PER_S)
