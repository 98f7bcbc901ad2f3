"""Parallel modes: a shard mesh on ``torch.distributed``, data-parallel
graph training, and the edge-, band- and hybrid-partitioned giant-graph
models with the 2-D (data × edge) step.

The port of ``connectome_gnn_tpu/parallel/`` (slices E1 and E2).  A rank
is one process driving one device and holding a contiguous range of the
mesh's shards as a leading tensor axis; collectives run over the local
shards and, through NCCL on ``cuda`` or gloo on ``cpu``, across ranks.
:mod:`~connectome_gnn_tpu_torch.parallel.launch` runs the modes in several
processes and holds them to one.  Sampled data parallelism, graph-sharded
sampling and the traffic census (slice E3) are not ported yet.
"""

from connectome_gnn_tpu_torch.parallel.banded_partition import (
    PartitionedBanded,
    ShardedBandedGCN,
    ShardedBandedSAGE,
    halo_exchange,
    make_banded_train_step_2d,
    make_sharded_banded_train_step,
    partition_banded,
    partition_banded_from_coo,
    stack_partitioned,
)
from connectome_gnn_tpu_torch.parallel.data_parallel import (
    make_dp_eval_step,
    make_dp_train_step,
    merge_shards,
    shard_batch,
    stack_batches,
)
from connectome_gnn_tpu_torch.parallel.distributed import (
    assemble_global,
    initialize_distributed,
    local_shard_range,
    process_count,
    process_index,
    shutdown_distributed,
)
from connectome_gnn_tpu_torch.parallel.edge_partition import (
    EdgePartitionedGCN,
    EdgePartitionedSAGE,
    PartitionedGraph,
    make_partitioned_train_step,
    partition_graph,
    partitioned_gcn_layer,
    partitioned_sage_layer,
)
from connectome_gnn_tpu_torch.parallel.hybrid_partition import (
    PartitionedHybrid,
    exchange_rows,
    hybrid_remainder_capacities,
    partition_hybrid,
    partition_hybrid_cohort,
    partition_hybrid_from_coo,
    remainder_aggregate,
    remainder_table,
    reverse_scatter,
)
from connectome_gnn_tpu_torch.parallel.mesh import Mesh, create_mesh
from connectome_gnn_tpu_torch.parallel.shard_forward import (
    ShardForwardMixin,
    apply_global_update,
    reduce_gradients,
)

__all__ = [
    "EdgePartitionedGCN",
    "EdgePartitionedSAGE",
    "Mesh",
    "PartitionedBanded",
    "PartitionedGraph",
    "PartitionedHybrid",
    "ShardForwardMixin",
    "ShardedBandedGCN",
    "ShardedBandedSAGE",
    "apply_global_update",
    "assemble_global",
    "create_mesh",
    "exchange_rows",
    "halo_exchange",
    "hybrid_remainder_capacities",
    "initialize_distributed",
    "local_shard_range",
    "make_banded_train_step_2d",
    "make_dp_eval_step",
    "make_dp_train_step",
    "make_partitioned_train_step",
    "make_sharded_banded_train_step",
    "merge_shards",
    "partition_banded",
    "partition_banded_from_coo",
    "partition_graph",
    "partition_hybrid",
    "partition_hybrid_cohort",
    "partition_hybrid_from_coo",
    "partitioned_gcn_layer",
    "partitioned_sage_layer",
    "process_count",
    "process_index",
    "reduce_gradients",
    "remainder_aggregate",
    "remainder_table",
    "reverse_scatter",
    "shard_batch",
    "shutdown_distributed",
    "stack_batches",
    "stack_partitioned",
]
