"""Node-level GCN over a banded giant graph (single device).

The port of ``connectome_gnn_tpu/models/node_gcn.py``: a spatially ordered
(or RCM-reordered) giant connectome in banded block-dense form, L
symmetric-normalized GCN convolutions over the band, masked BatchNorm,
ReLU and dropout per layer, and a per-node linear head.

Serving runs on an int8 band (:meth:`BandedNodeGCN.prepare_quantized`,
:meth:`BandedNodeGCN.apply_quantized`) through the hand-written kernels of
:mod:`connectome_gnn_tpu_torch.ops.banded_quant`: K4 by default, K5 with
``w8a8``, K3 for row-major and hybrid adjacencies.  Parameter names follow
the port's convention: ``convs.{i}.linear.weight``, ``convs.{i}.bias``,
``batch_norms.{i}.*``, ``head.weight``, ``head.bias``.

Waiting for the training slice: ``prepare_quant_trainable``,
``apply_quant_trainable`` and its blocked variant.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from connectome_gnn_tpu_torch.models.layers import GCNConv
from connectome_gnn_tpu_torch.nn.layers import Dense, MaskedBatchNorm
from connectome_gnn_tpu_torch.ops.banded import (
    HybridMatrix,
    banded_spmm,
    gcn_normalize_banded,
    gcn_normalize_hybrid,
    hybrid_spmm,
)
from connectome_gnn_tpu_torch.ops.banded_quant import (
    QuantizedBandedMatrixFM,
    quantize_band,
    quantize_hybrid,
    serving_spmm,
    to_feature_major,
)


def require_eval(model: nn.Module) -> None:
    if model.training:
        raise ValueError("quantized serving is an eval-mode path; call model.eval() first")


class BandedNodeGCN(nn.Module):
    """L-layer node-classification GCN over a :class:`BandedMatrix` or a
    :class:`HybridMatrix`.  Train or eval mode is the module's own."""

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
            GCNConv(dims[i], dims[i + 1], generator=generator) for i in range(self.num_layers)
        )
        self.batch_norms = nn.ModuleList(
            MaskedBatchNorm(self.hidden_dim) for _ in range(self.num_layers)
        )
        self.head = Dense(self.hidden_dim, self.num_classes, generator=generator)
        self.dropout = nn.Dropout(dropout)

    def forward(self, adjacency, x: torch.Tensor, *, node_mask=None) -> torch.Tensor:
        """Per-node logits ``[num_nodes, C]`` in float32, normalizing the
        adjacency on every call (identical numerics for a pure band and a
        hybrid)."""
        return self.apply_normalized(*self.prepare(adjacency), x, node_mask=node_mask)

    @torch.no_grad()
    def prepare(self, adjacency, *, band_dtype: str = "float32"):
        """One-time setup: GCN-normalize the adjacency.  Returns
        ``(adj_norm, dinv)`` for :meth:`apply_normalized`.
        ``band_dtype="bfloat16"`` (pure bands) stores the normalized band
        in half the bytes; :func:`banded_spmm` widens it per diagonal."""
        if isinstance(adjacency, HybridMatrix):
            if band_dtype != "float32":
                raise ValueError(
                    "band_dtype is a pure-band option (the hybrid remainder path is f32)"
                )
            return gcn_normalize_hybrid(adjacency)
        if band_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"band_dtype must be float32/bfloat16, got {band_dtype!r}")
        adj_norm, dinv = gcn_normalize_banded(adjacency)
        if band_dtype == "bfloat16":
            adj_norm = adj_norm._replace(band=adj_norm.band.to(torch.bfloat16))
        return adj_norm, dinv

    def apply_normalized(self, adj_norm, dinv, x, *, node_mask=None) -> torch.Tensor:
        """:meth:`forward` over a :meth:`prepare`-d adjacency."""
        spmm = hybrid_spmm if isinstance(adj_norm, HybridMatrix) else banded_spmm
        return self._forward(spmm, adj_norm, dinv, x, node_mask)

    @torch.no_grad()
    def prepare_quantized(self, adjacency, feature_major: bool = True):
        """One-time serving setup: GCN-normalize, then int8-quantize the
        normalized band per tile.  Returns ``(adj_q, dinv)`` for
        :meth:`apply_quantized`.  ``feature_major`` (pure bands) stores the
        tiles transposed for K4/K5; hybrid adjacencies stay row-major (the
        scatter remainder wants node-major rows)."""
        if isinstance(adjacency, HybridMatrix):
            adj_norm, dinv = gcn_normalize_hybrid(adjacency)
            return quantize_hybrid(adj_norm), dinv
        adj_norm, dinv = gcn_normalize_banded(adjacency)
        q = quantize_band(adj_norm)
        return (to_feature_major(q) if feature_major else q), dinv

    @torch.no_grad()
    def apply_quantized(
        self, adj_q, dinv, x, *, node_mask=None, w8a8: bool = False, plain: bool = False
    ) -> torch.Tensor:
        """Eval-mode logits ``[num_nodes, C]`` over a
        :meth:`prepare_quantized` adjacency; BatchNorm uses its running
        moments and the model must be in eval mode.

        A feature-major adjacency keeps activations ``[F, N]`` across
        layers and runs K4, or K5 with ``w8a8`` (int8 activations; a
        row-major adjacency then raises ``ValueError``).  Row-major and
        hybrid adjacencies run K3.  ``plain=True`` runs the kernels' plain
        PyTorch versions instead, on any device.
        """
        require_eval(self)
        spmm = serving_spmm(adj_q, w8a8=w8a8, plain=plain)
        if isinstance(adj_q, QuantizedBandedMatrixFM):
            return self._forward_quant_fm(spmm, adj_q, dinv, x)
        return self._forward(spmm, adj_q, dinv, x, node_mask)

    def _forward_quant_fm(self, spmm, adj_q, dinv, x) -> torch.Tensor:
        """Layout-persistent serving: activations stay feature-major across
        layers; only the input and the logits transpose."""
        n = adj_q.num_nodes
        self_normT = (dinv * dinv)[None, :n]
        hT = x[:n].T
        for conv, norm in zip(self.convs, self.batch_norms):
            hwT = conv.linear.weight @ hT
            hT = spmm(adj_q, hwT) + self_normT * hwT + conv.bias[:, None]
            hT = torch.relu(norm.forward_eval_fm(hT))
        logitsT = self.head.weight @ hT
        if self.head.bias is not None:
            logitsT = logitsT + self.head.bias[:, None]
        return logitsT.T

    def _forward(self, spmm, adj_norm, dinv, x, node_mask) -> torch.Tensor:
        n = adj_norm.num_nodes
        if node_mask is None:
            node_mask = torch.ones(n, dtype=torch.bool, device=x.device)
        self_norm = (dinv * dinv)[:n, None]
        h = x[:n]
        for conv, norm in zip(self.convs, self.batch_norms):
            hw = conv.linear(h)
            h = spmm(adj_norm, hw) + self_norm * hw + conv.bias
            h = self.dropout(torch.relu(norm(h, node_mask)))
        return self.head(h)
