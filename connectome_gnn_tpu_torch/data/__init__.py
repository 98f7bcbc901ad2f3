"""Data layer: atlas, synthetic connectomes and giant spatial graphs, graph
containers, padded batches (COO and dense), loader, prefetching, RCM and
spectral reordering, and the giant-graph layout planner."""

from connectome_gnn_tpu_torch.data.atlas import NUM_REGIONS, REGION_NAMES
from connectome_gnn_tpu_torch.data.batch import ConnectomeBatch, collate_graphs, round_up, to_device
from connectome_gnn_tpu_torch.data.dense import DenseConnectomeBatch, collate_dense
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
    "LayoutPlan",
    "PrefetchIterator",
    "PrefetchLoader",
    "apply_ordering",
    "auto_layout",
    "bandwidth",
    "build_layout",
    "collate_dense",
    "collate_graphs",
    "generate_connectome",
    "generate_dataset",
    "generate_spatial_graph",
    "plan_layout",
    "reverse_cuthill_mckee",
    "round_up",
    "small_world_stats",
    "spectral_ordering",
    "to_device",
]
