"""Fleet batch assembly, the fleet programs and the packed window programs
(one device), under the JAX package's import names."""

from kepler_tpu_torch.parallel.aggregator_core import (
    FleetProgram,
    FleetResult,
    fleet_attribution_program,
    make_fleet_program,
    make_temporal_fleet_program,
    run_fleet_attribution,
    temporal_fleet_program,
)
from kepler_tpu_torch.parallel.fleet import (
    MODE_MODEL,
    MODE_RATIO,
    FleetBatch,
    NodeReport,
    assemble_fleet_batch,
)

__all__ = [
    "FleetBatch",
    "FleetProgram",
    "FleetResult",
    "MODE_MODEL",
    "MODE_RATIO",
    "NodeReport",
    "assemble_fleet_batch",
    "fleet_attribution_program",
    "make_fleet_program",
    "make_temporal_fleet_program",
    "run_fleet_attribution",
    "temporal_fleet_program",
]
