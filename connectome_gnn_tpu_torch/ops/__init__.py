"""Compute ops: segment reductions, COO SpMM, GCN normalization, and the
banded giant-graph SpMMs (float32 in plain torch; int8 through the K3, K4
and K5 kernels).

The fused whole-model forward kernels live in
:mod:`connectome_gnn_tpu_torch.ops.fused`, which is not imported here:
it depends on the models, which depend on these ops.
"""

from connectome_gnn_tpu_torch.ops.banded import (
    BandedMatrix,
    HybridMatrix,
    banded_row_sum,
    banded_sender_degree,
    banded_spmm,
    gcn_normalize_banded,
    gcn_normalize_hybrid,
    hybrid_row_sum,
    hybrid_sender_degree,
    hybrid_spmm,
    to_banded,
    to_hybrid,
)
from connectome_gnn_tpu_torch.ops.banded_quant import (
    QuantizedBandedMatrix,
    QuantizedBandedMatrixFM,
    QuantizedHybridMatrix,
    banded_spmm_quant,
    banded_spmm_quant_fm,
    banded_spmm_quant_fm_w8a8,
    banded_spmm_quant_xla,
    dequantize_band,
    hybrid_spmm_quant,
    quantize_activations_fm,
    quantize_band,
    quantize_hybrid,
    to_feature_major,
)
from connectome_gnn_tpu_torch.ops.gcn_norm import GCNNorm, gcn_normalize
from connectome_gnn_tpu_torch.ops.segment import (
    coo_spmm,
    graph_mean_pool,
    segment_mean,
    segment_sum,
)

__all__ = [
    "BandedMatrix",
    "GCNNorm",
    "HybridMatrix",
    "QuantizedBandedMatrix",
    "QuantizedBandedMatrixFM",
    "QuantizedHybridMatrix",
    "banded_row_sum",
    "banded_sender_degree",
    "banded_spmm",
    "banded_spmm_quant",
    "banded_spmm_quant_fm",
    "banded_spmm_quant_fm_w8a8",
    "banded_spmm_quant_xla",
    "coo_spmm",
    "dequantize_band",
    "gcn_normalize",
    "gcn_normalize_banded",
    "gcn_normalize_hybrid",
    "graph_mean_pool",
    "hybrid_row_sum",
    "hybrid_sender_degree",
    "hybrid_spmm",
    "hybrid_spmm_quant",
    "quantize_activations_fm",
    "quantize_band",
    "quantize_hybrid",
    "segment_mean",
    "segment_sum",
    "to_banded",
    "to_feature_major",
    "to_hybrid",
]
