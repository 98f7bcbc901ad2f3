"""Neural-net building blocks: dense, masked BatchNorm, dropout, initializers."""

from connectome_gnn_tpu_torch.nn.initializers import (
    torch_linear_bias,
    torch_linear_kernel,
    xavier_uniform,
)
from connectome_gnn_tpu_torch.nn.layers import Dense, Dropout, MaskedBatchNorm

__all__ = [
    "Dense",
    "Dropout",
    "MaskedBatchNorm",
    "torch_linear_bias",
    "torch_linear_kernel",
    "xavier_uniform",
]
