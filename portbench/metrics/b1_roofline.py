"""Kernel B1's share of its roofline: the least time its bytes take at
the HBM rate (``costs.b1_cost`` at the configuration's padded shapes)
over its mean profiler time a launch, in %."""

from portbench import costs, fleetgen

B1 = "outer_product_kernel"


def read(r):
    if r.trace is None:
        return None
    times = r.trace.durations(lambda o: o.cat == "kernel" and B1 in o.name)
    if not times:
        return None
    fleet = fleetgen.Fleet.of(r.config)
    least = costs.bound_s(*costs.b1_cost(fleet.n, fleet.w, fleet.zones))
    return 100.0 * least * len(times) / sum(times)
