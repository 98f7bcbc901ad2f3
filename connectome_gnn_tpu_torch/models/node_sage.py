"""Node-level GraphSAGE over a banded giant graph (single device).

The port of ``connectome_gnn_tpu/models/node_sage.py``: L weighted-mean
SAGE convolutions (messages ``x[src]·w``, normalizer the incident-weight
sum ``+1e-8``, concat-project-ReLU, no self-loops) over the block band,
then masked BatchNorm and dropout per layer, with NO ReLU after the
BatchNorm (the reference SAGE asymmetry), and a per-node linear head.
Accepts a :class:`BandedMatrix` or a :class:`HybridMatrix`.

Serving runs on an int8 band through K4 (feature-major) or K3 (row-major,
hybrid).  Its feature-major path aggregates before projecting, so its first
layer runs K4 at ``F = in_channels``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from connectome_gnn_tpu_torch.models.layers import EPS, SAGEConv
from connectome_gnn_tpu_torch.models.node_gcn import require_eval
from connectome_gnn_tpu_torch.nn.layers import Dense, MaskedBatchNorm
from connectome_gnn_tpu_torch.ops.banded import (
    HybridMatrix,
    banded_row_sum,
    banded_spmm,
    hybrid_row_sum,
    hybrid_spmm,
)
from connectome_gnn_tpu_torch.ops.banded_quant import (
    QuantizedBandedMatrixFM,
    quantize_band,
    quantize_hybrid,
    serving_spmm,
    to_feature_major,
)


class BandedNodeSAGE(nn.Module):
    """L-layer node-classification GraphSAGE over a block-banded graph."""

    def __init__(
        self,
        in_channels: int,
        hidden_dim: int = 64,
        num_classes: int = 2,
        num_layers: int = 3,
        dropout: float = 0.0,
        *,
        generator: Optional[torch.Generator] = None,
    ):
        """Weights are drawn from ``generator`` (default: a fresh generator
        seeded 0): conv layers in order, then the head."""
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.in_channels = int(in_channels)
        self.hidden_dim = int(hidden_dim)
        self.num_classes = int(num_classes)
        self.num_layers = int(num_layers)
        dims = [self.in_channels] + [self.hidden_dim] * self.num_layers
        self.convs = nn.ModuleList(
            SAGEConv(dims[i], dims[i + 1], generator=generator) for i in range(self.num_layers)
        )
        self.batch_norms = nn.ModuleList(
            MaskedBatchNorm(self.hidden_dim) for _ in range(self.num_layers)
        )
        self.head = Dense(self.hidden_dim, self.num_classes, generator=generator)
        self.dropout = nn.Dropout(dropout)

    def forward(self, adjacency, x: torch.Tensor, *, node_mask=None) -> torch.Tensor:
        """Per-node logits ``[num_nodes, C]`` in float32."""
        if isinstance(adjacency, HybridMatrix):
            spmm, w_sum = hybrid_spmm, hybrid_row_sum(adjacency)
        else:
            spmm, w_sum = banded_spmm, banded_row_sum(adjacency)
        return self._forward(spmm, adjacency, w_sum, x, node_mask)

    @torch.no_grad()
    def prepare_quantized(self, adjacency, feature_major: bool = True):
        """One-time serving setup: int8-quantize the raw-weight band and
        take the mean normalizer from the float32 band BEFORE quantization,
        so the denominator stays exact.  Returns ``(adj_q, w_sum)`` for
        :meth:`apply_quantized`; hybrid adjacencies stay row-major."""
        if isinstance(adjacency, HybridMatrix):
            return quantize_hybrid(adjacency), hybrid_row_sum(adjacency)
        q = quantize_band(adjacency)
        return (to_feature_major(q) if feature_major else q), banded_row_sum(adjacency)

    @torch.no_grad()
    def apply_quantized(self, adj_q, w_sum, x, *, node_mask=None, plain: bool = False) -> torch.Tensor:
        """Eval-mode logits over a :meth:`prepare_quantized` adjacency (the
        model must be in eval mode).  ``plain=True`` runs the kernels'
        plain PyTorch versions instead, on any device."""
        require_eval(self)
        spmm = serving_spmm(adj_q, plain=plain)
        if isinstance(adj_q, QuantizedBandedMatrixFM):
            return self._forward_quant_fm(spmm, adj_q, w_sum, x)
        return self._forward(spmm, adj_q, w_sum, x, node_mask)

    def _forward_quant_fm(self, spmm, adj_q, w_sum, x) -> torch.Tensor:
        """Layout-persistent serving (feature-major activations); the
        concat becomes an axis-0 concatenation in ``[F, N]`` layout."""
        n = adj_q.num_nodes
        w_sumT = w_sum[None, :n]
        hT = x[:n].T.contiguous()
        for conv, norm in zip(self.convs, self.batch_norms):
            aggT = spmm(adj_q, hT) / (w_sumT + EPS)
            hT = conv.linear.weight @ torch.cat([hT, aggT], dim=0)
            if conv.linear.bias is not None:
                hT = hT + conv.linear.bias[:, None]
            # the reference SAGE asymmetry: no ReLU after the BatchNorm
            hT = norm.forward_eval_fm(torch.relu(hT))
        logitsT = self.head.weight @ hT
        if self.head.bias is not None:
            logitsT = logitsT + self.head.bias[:, None]
        return logitsT.T

    def _forward(self, spmm, adjacency, w_sum, x, node_mask) -> torch.Tensor:
        n = adjacency.num_nodes
        if node_mask is None:
            node_mask = torch.ones(n, dtype=torch.bool, device=x.device)
        w_sum = w_sum[:n][:, None]
        h = x[:n]
        for conv, norm in zip(self.convs, self.batch_norms):
            agg = spmm(adjacency, h)[:n] / (w_sum + EPS)
            h = torch.relu(conv.linear(torch.cat([h, agg], dim=1)))
            # the reference SAGE asymmetry: no ReLU after the BatchNorm
            h = self.dropout(norm(h, node_mask))
        return self.head(h)
