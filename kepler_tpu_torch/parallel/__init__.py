"""Fleet batch assembly, the fleet programs, the packed window programs
and the device mesh (with the multi-process join), under the JAX
package's import names."""

from kepler_tpu_torch.parallel.aggregator_core import (
    FleetProgram,
    FleetResult,
    fleet_attribution_program,
    make_fleet_program,
    make_temporal_fleet_program,
    run_fleet_attribution,
    shard_by_node,
    temporal_fleet_program,
)
from kepler_tpu_torch.parallel.fleet import (
    MODE_MODEL,
    MODE_RATIO,
    FleetBatch,
    NodeReport,
    assemble_fleet_batch,
)
from kepler_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    NODE_AXIS,
    Mesh,
    MultihostInit,
    Shard,
    initialize_multihost,
    make_mesh,
    multihost_status,
    submesh_for_processes,
)

__all__ = [
    "FleetBatch",
    "FleetProgram",
    "FleetResult",
    "MODE_MODEL",
    "MODE_RATIO",
    "MODEL_AXIS",
    "Mesh",
    "MultihostInit",
    "NODE_AXIS",
    "NodeReport",
    "Shard",
    "assemble_fleet_batch",
    "fleet_attribution_program",
    "make_fleet_program",
    "initialize_multihost",
    "make_mesh",
    "make_temporal_fleet_program",
    "multihost_status",
    "run_fleet_attribution",
    "shard_by_node",
    "submesh_for_processes",
    "temporal_fleet_program",
]
