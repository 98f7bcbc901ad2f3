"""Compute ops: segment reductions, COO SpMM and GCN normalization.

The fused whole-model forward kernels live in
:mod:`connectome_gnn_tpu_torch.ops.fused`, which is not imported here:
it depends on the models, which depend on these ops.
"""

from connectome_gnn_tpu_torch.ops.gcn_norm import GCNNorm, gcn_normalize
from connectome_gnn_tpu_torch.ops.segment import (
    coo_spmm,
    graph_mean_pool,
    segment_mean,
    segment_sum,
)

__all__ = [
    "GCNNorm",
    "coo_spmm",
    "gcn_normalize",
    "graph_mean_pool",
    "segment_mean",
    "segment_sum",
]
