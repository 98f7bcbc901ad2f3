"""Data layer: atlas, synthetic connectomes and giant spatial graphs, graph
containers, padded batches (COO and dense), loader, prefetching, RCM and
spectral reordering, the giant-graph layout planner, and sampled node
training: the host sampler and its loader, and device-side sampling."""

from connectome_gnn_tpu_torch.data.atlas import NUM_REGIONS, REGION_NAMES
from connectome_gnn_tpu_torch.data.batch import ConnectomeBatch, collate_graphs, round_up, to_device
from connectome_gnn_tpu_torch.data.dense import DenseConnectomeBatch, collate_dense
from connectome_gnn_tpu_torch.data.device_sampling import (
    DeviceGraphCSR,
    DeviceSampledModel,
    DeviceSeedLoader,
    SeedBatch,
    cap_in_degree_mask,
    device_sample,
    device_sampled_gcn,
    device_sampled_sage,
    hop_draws,
    make_seed_batch,
    pack_epoch,
    pack_epoch_sharded,
)
from connectome_gnn_tpu_torch.data.graph import ConnectomeGraph
from connectome_gnn_tpu_torch.data.layout import (
    LayoutPlan,
    auto_layout,
    build_layout,
    plan_layout,
)
from connectome_gnn_tpu_torch.data.loader import ConnectomeDataLoader
from connectome_gnn_tpu_torch.data.prefetch import PrefetchIterator, PrefetchLoader
from connectome_gnn_tpu_torch.data.reorder import (
    apply_ordering,
    bandwidth,
    reverse_cuthill_mckee,
    spectral_ordering,
)
from connectome_gnn_tpu_torch.data.sampled import (
    HopBlock,
    SampledNodeBatch,
    SampledNodeLoader,
    collate_sampled,
    fanout_budgets,
    full_graph_batch,
)
from connectome_gnn_tpu_torch.data.sampling import (
    NeighborSampler,
    sample_subgraph,
    sample_subgraph_fast,
)
from connectome_gnn_tpu_torch.data.synthetic import (
    TRAIT_NAMES,
    generate_connectome,
    generate_dataset,
    generate_spatial_graph,
    small_world_stats,
)

__all__ = [
    "NUM_REGIONS",
    "REGION_NAMES",
    "TRAIT_NAMES",
    "ConnectomeBatch",
    "ConnectomeDataLoader",
    "ConnectomeGraph",
    "DenseConnectomeBatch",
    "DeviceGraphCSR",
    "DeviceSampledModel",
    "DeviceSeedLoader",
    "HopBlock",
    "LayoutPlan",
    "NeighborSampler",
    "PrefetchIterator",
    "PrefetchLoader",
    "SampledNodeBatch",
    "SampledNodeLoader",
    "SeedBatch",
    "apply_ordering",
    "auto_layout",
    "bandwidth",
    "build_layout",
    "cap_in_degree_mask",
    "collate_dense",
    "collate_graphs",
    "collate_sampled",
    "device_sample",
    "device_sampled_gcn",
    "device_sampled_sage",
    "fanout_budgets",
    "full_graph_batch",
    "generate_connectome",
    "generate_dataset",
    "generate_spatial_graph",
    "hop_draws",
    "make_seed_batch",
    "pack_epoch",
    "pack_epoch_sharded",
    "plan_layout",
    "reverse_cuthill_mckee",
    "round_up",
    "sample_subgraph",
    "sample_subgraph_fast",
    "small_world_stats",
    "spectral_ordering",
    "to_device",
]
