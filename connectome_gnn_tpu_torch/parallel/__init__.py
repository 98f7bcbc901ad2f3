"""Parallel modes: a shard mesh on ``torch.distributed``, data-parallel
graph and sampled node training, the edge-, band- and hybrid-partitioned
giant-graph models with the 2-D (data × edge) step, graph-sharded sampling
and the collective-bytes census.

The port of ``connectome_gnn_tpu/parallel/``.  A rank is one process
driving one device and holding a contiguous range of the mesh's shards as a
leading tensor axis; collectives run over the local shards and, through
NCCL on ``cuda`` or gloo on ``cpu``, across ranks.
:mod:`~connectome_gnn_tpu_torch.parallel.launch` runs the modes in several
processes and holds them to one.
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
from connectome_gnn_tpu_torch.parallel.comm_accounting import count_collective_bytes
from connectome_gnn_tpu_torch.parallel.data_parallel import (
    make_dp_eval_step,
    make_dp_train_step,
    merge_sampled,
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
from connectome_gnn_tpu_torch.parallel.sampled_dp import (
    make_device_sampled_dp_epoch_runner,
    make_device_sampled_dp_eval_step,
    make_device_sampled_dp_step,
    replicate_csr,
)
from connectome_gnn_tpu_torch.parallel.sharded_sampling import (
    CompactionConfig,
    GraphShardedSampledModel,
    ShardedGraphCSR,
    graph_sharded_sage,
    make_graph_sharded_eval_step,
    make_graph_sharded_sampled_forward,
    make_graph_sharded_train_step,
    plan_compaction,
    shard_csr,
    sharded_device_sample,
    sharded_device_sample_with_stats,
    sharded_sampling_census,
    sharded_sampling_comm_model,
)
from connectome_gnn_tpu_torch.parallel.shard_forward import (
    ShardForwardMixin,
    apply_global_update,
    reduce_gradients,
)

__all__ = [
    "CompactionConfig",
    "EdgePartitionedGCN",
    "EdgePartitionedSAGE",
    "GraphShardedSampledModel",
    "Mesh",
    "PartitionedBanded",
    "PartitionedGraph",
    "PartitionedHybrid",
    "ShardForwardMixin",
    "ShardedBandedGCN",
    "ShardedBandedSAGE",
    "ShardedGraphCSR",
    "apply_global_update",
    "assemble_global",
    "count_collective_bytes",
    "create_mesh",
    "exchange_rows",
    "graph_sharded_sage",
    "halo_exchange",
    "hybrid_remainder_capacities",
    "initialize_distributed",
    "local_shard_range",
    "make_banded_train_step_2d",
    "make_device_sampled_dp_epoch_runner",
    "make_device_sampled_dp_eval_step",
    "make_device_sampled_dp_step",
    "make_dp_eval_step",
    "make_dp_train_step",
    "make_graph_sharded_eval_step",
    "make_graph_sharded_sampled_forward",
    "make_graph_sharded_train_step",
    "make_partitioned_train_step",
    "make_sharded_banded_train_step",
    "merge_sampled",
    "merge_shards",
    "partition_banded",
    "partition_banded_from_coo",
    "partition_graph",
    "partition_hybrid",
    "partition_hybrid_cohort",
    "partition_hybrid_from_coo",
    "partitioned_gcn_layer",
    "partitioned_sage_layer",
    "plan_compaction",
    "process_count",
    "process_index",
    "reduce_gradients",
    "remainder_aggregate",
    "remainder_table",
    "replicate_csr",
    "reverse_scatter",
    "shard_batch",
    "shard_csr",
    "sharded_device_sample",
    "sharded_device_sample_with_stats",
    "sharded_sampling_census",
    "sharded_sampling_comm_model",
    "shutdown_distributed",
    "stack_batches",
    "stack_partitioned",
]
