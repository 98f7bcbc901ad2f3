"""Model families: GCN and GraphSAGE connectome classifiers, the
node-level GCN and GraphSAGE over a banded giant graph, and the COO node
models of sampled training."""

from connectome_gnn_tpu_torch.models.compat import (
    load_jax_params,
    reference_state_dict_from_params,
)
from connectome_gnn_tpu_torch.models.connectome import (
    GCNConnectome,
    GraphSAGEConnectome,
)
from connectome_gnn_tpu_torch.models.layers import GCNConv, SAGEConv
from connectome_gnn_tpu_torch.models.node_coo import (
    BlockedNodeGCN,
    BlockedNodeSAGE,
    NodeGCN,
    NodeSAGE,
)
from connectome_gnn_tpu_torch.models.node_gcn import BandedNodeGCN
from connectome_gnn_tpu_torch.models.node_sage import BandedNodeSAGE

__all__ = [
    "BandedNodeGCN",
    "BandedNodeSAGE",
    "BlockedNodeGCN",
    "BlockedNodeSAGE",
    "GCNConnectome",
    "GCNConv",
    "GraphSAGEConnectome",
    "NodeGCN",
    "NodeSAGE",
    "SAGEConv",
    "load_jax_params",
    "reference_state_dict_from_params",
]
