"""Fleet batch assembly, the fleet programs, the packed window programs,
the device mesh (with the multi-process join) and the parallel families
(ring and Ulysses attention, sequence parallelism, the GPipe pipeline,
expert parallelism, the DP×TP trainer), under the JAX package's import
names."""

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
from kepler_tpu_torch.parallel.expert import (
    EXPERT_AXIS,
    make_expert_parallel_moe,
    top1_route,
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
    local_shards,
    make_mesh,
    multihost_status,
    submesh_for_processes,
)
from kepler_tpu_torch.parallel.pipeline import (
    STAGE_AXIS,
    make_pipeline,
    make_pipelined_deep,
)
from kepler_tpu_torch.parallel.ring import (
    SEQ_AXIS,
    full_attention,
    make_ring_attention,
    ring_attention_shardmap,
)
from kepler_tpu_torch.parallel.sequence import (
    make_sequence_parallel_train_step,
    make_temporal_program,
)
from kepler_tpu_torch.parallel.trainer import (
    ShardedTrainState,
    gather_params,
    make_distributed_train_step,
    mlp_param_shardings,
    shard_train_state,
)
from kepler_tpu_torch.parallel.ulysses import (
    make_ulysses_attention,
    make_ulysses_temporal_program,
    ulysses_attention_shardmap,
)

__all__ = [
    "EXPERT_AXIS",
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
    "SEQ_AXIS",
    "STAGE_AXIS",
    "Shard",
    "ShardedTrainState",
    "assemble_fleet_batch",
    "fleet_attribution_program",
    "full_attention",
    "gather_params",
    "initialize_multihost",
    "make_distributed_train_step",
    "make_expert_parallel_moe",
    "make_fleet_program",
    "local_shards",
    "make_mesh",
    "make_pipeline",
    "make_pipelined_deep",
    "make_ring_attention",
    "make_sequence_parallel_train_step",
    "make_temporal_fleet_program",
    "make_temporal_program",
    "make_ulysses_attention",
    "make_ulysses_temporal_program",
    "mlp_param_shardings",
    "multihost_status",
    "ring_attention_shardmap",
    "run_fleet_attribution",
    "shard_by_node",
    "shard_train_state",
    "submesh_for_processes",
    "temporal_fleet_program",
    "top1_route",
    "ulysses_attention_shardmap",
]
