"""Compute ops: segment reductions, COO SpMM, GCN normalization, and the
banded giant-graph SpMMs (float32 in plain torch; int8 through the K3, K4,
K5 and K6 kernels, and trainable through K4 and K6; the float32 or
bfloat16 band through K7, and the variants B2a-B2c).

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
    transpose_banded,
)
from connectome_gnn_tpu_torch.ops.band_variants import (
    banded_spmm_bf16,
    banded_spmm_quant_fused_dot,
    banded_spmm_quant_manual,
    banded_spmm_w8a8,
    quantize_x_blocks,
)
from connectome_gnn_tpu_torch.ops.banded_direct import banded_spmm_direct
from connectome_gnn_tpu_torch.ops.banded_quant import (
    QuantizedBandedMatrix,
    QuantizedBandedMatrixFM,
    QuantizedHybridMatrix,
    banded_spmm_quant,
    banded_spmm_quant_blocked,
    banded_spmm_quant_blocked_grad,
    banded_spmm_quant_fm,
    banded_spmm_quant_fm_grad,
    banded_spmm_quant_fm_w8a8,
    banded_spmm_quant_xla,
    dequantize_band,
    from_blocked,
    hybrid_spmm_quant,
    quantize_activations_fm,
    quantize_band,
    quantize_hybrid,
    quantize_transposed_fm,
    to_blocked,
    to_feature_major,
    transpose_quantized,
    transposed_feature_major,
)
from connectome_gnn_tpu_torch.ops.gcn_norm import GCNNorm, gcn_normalize
from connectome_gnn_tpu_torch.ops.segment import (
    coo_spmm,
    graph_mean_pool,
    sddmm,
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
    "banded_spmm_bf16",
    "banded_spmm_direct",
    "banded_spmm_quant",
    "banded_spmm_quant_blocked",
    "banded_spmm_quant_blocked_grad",
    "banded_spmm_quant_fm",
    "banded_spmm_quant_fm_grad",
    "banded_spmm_quant_fm_w8a8",
    "banded_spmm_quant_fused_dot",
    "banded_spmm_quant_manual",
    "banded_spmm_quant_xla",
    "banded_spmm_w8a8",
    "coo_spmm",
    "dequantize_band",
    "from_blocked",
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
    "quantize_transposed_fm",
    "quantize_x_blocks",
    "sddmm",
    "segment_mean",
    "segment_sum",
    "to_banded",
    "to_blocked",
    "to_feature_major",
    "to_hybrid",
    "transpose_banded",
    "transpose_quantized",
    "transposed_feature_major",
]
