"""Model families: GCN and GraphSAGE connectome classifiers."""

from connectome_gnn_tpu_torch.models.compat import (
    load_jax_params,
    reference_state_dict_from_params,
)
from connectome_gnn_tpu_torch.models.connectome import (
    GCNConnectome,
    GraphSAGEConnectome,
)
from connectome_gnn_tpu_torch.models.layers import GCNConv, SAGEConv

__all__ = [
    "GCNConnectome",
    "GCNConv",
    "GraphSAGEConnectome",
    "SAGEConv",
    "load_jax_params",
    "reference_state_dict_from_params",
]
