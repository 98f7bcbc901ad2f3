"""Model families: GCN and GraphSAGE connectome classifiers, and the
node-level GCN and GraphSAGE over a banded giant graph."""

from connectome_gnn_tpu_torch.models.compat import (
    load_jax_params,
    reference_state_dict_from_params,
)
from connectome_gnn_tpu_torch.models.connectome import (
    GCNConnectome,
    GraphSAGEConnectome,
)
from connectome_gnn_tpu_torch.models.layers import GCNConv, SAGEConv
from connectome_gnn_tpu_torch.models.node_gcn import BandedNodeGCN
from connectome_gnn_tpu_torch.models.node_sage import BandedNodeSAGE

__all__ = [
    "BandedNodeGCN",
    "BandedNodeSAGE",
    "GCNConnectome",
    "GCNConv",
    "GraphSAGEConnectome",
    "SAGEConv",
    "load_jax_params",
    "reference_state_dict_from_params",
]
