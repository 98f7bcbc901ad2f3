"""Connectome classification models: GCN and GraphSAGE.

Architecture (reference ``connectome_gnn/models.py:159-266``, as in
``connectome_gnn_tpu.models.connectome``):

    node features → conv × L (with BatchNorm / activation / dropout)
                  → masked mean-pool per graph
                  → MLP head (Linear → ReLU → Dropout → Linear) → logits

GCN applies a ReLU after BatchNorm; SAGE does not (its ReLU lives inside
the SAGE layer).  Train or eval mode is the module's own (``.train()`` /
``.eval()``); BatchNorm updates its running moments in place in train mode.
Parameter names are the reference's ``state_dict`` keys: ``convs.{i}.*``,
``batch_norms.{i}.*``, ``classifier.0.*`` and ``classifier.3.*``.

``compute_dtype=torch.bfloat16`` is the JAX package's mixed precision: the
dense layout's matmul operands are rounded to bfloat16 and their products
summed in float32 (:func:`~connectome_gnn_tpu_torch.models.layers.mixed_matmul`);
parameters, BatchNorm statistics, the COO layout and the logits stay
float32.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from connectome_gnn_tpu_torch.data.batch import ConnectomeBatch
from connectome_gnn_tpu_torch.data.dense import DenseConnectomeBatch
from connectome_gnn_tpu_torch.models.layers import COMPUTE_DTYPES, GCNConv, SAGEConv
from connectome_gnn_tpu_torch.nn.layers import Dense, Dropout, MaskedBatchNorm
from connectome_gnn_tpu_torch.ops.segment import graph_mean_pool

Batch = Union[ConnectomeBatch, DenseConnectomeBatch]


class _ConnectomeModel(nn.Module):
    """Shared skeleton for connectome graph classifiers."""

    #: conv module class — set by subclasses
    _conv: type
    #: whether encode applies an explicit ReLU after BatchNorm
    _relu_after_norm: bool

    def __init__(
        self,
        in_channels: int,
        hidden_dim: int = 64,
        num_classes: int = 2,
        num_layers: int = 3,
        dropout: float = 0.3,
        *,
        compute_dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ):
        """Weights are drawn from ``generator`` (default: a fresh generator
        seeded 0): conv layers in order, then the two head layers.
        ``compute_dtype`` (``torch.float32`` or ``torch.bfloat16``) reaches
        only the dense layout's products."""
        super().__init__()
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, got {compute_dtype}")
        self.compute_dtype = compute_dtype
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.in_channels = int(in_channels)
        self.hidden_dim = int(hidden_dim)
        self.num_classes = int(num_classes)
        self.num_layers = int(num_layers)
        dims = [self.in_channels] + [self.hidden_dim] * self.num_layers
        self.convs = nn.ModuleList(
            type(self)._conv(dims[i], dims[i + 1], generator=generator)
            for i in range(self.num_layers)
        )
        self.batch_norms = nn.ModuleList(
            MaskedBatchNorm(self.hidden_dim) for _ in range(self.num_layers)
        )
        self.dropout = Dropout(dropout)
        self.classifier = nn.Sequential(
            Dense(self.hidden_dim, self.hidden_dim // 2, generator=generator),
            nn.ReLU(),
            Dropout(dropout),
            Dense(self.hidden_dim // 2, self.num_classes, generator=generator),
        )

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def encode(self, batch: Batch) -> torch.Tensor:
        """Graph-level embeddings ``[B, hidden_dim]``, dispatched on the
        batch layout (COO or dense) with identical numerics."""
        if isinstance(batch, DenseConnectomeBatch):
            return self._encode_dense(batch)
        x = batch.node_features
        for conv, norm in zip(self.convs, self.batch_norms):
            x = conv(x, batch.senders, batch.receivers, batch.edge_weight)
            x = norm(x, batch.node_mask)
            if type(self)._relu_after_norm:
                x = torch.relu(x)
            x = self.dropout(x)
        return graph_mean_pool(x, batch.node_graph_ids, batch.num_graphs)

    def _encode_dense(self, batch: DenseConnectomeBatch) -> torch.Tensor:
        B, n, _ = batch.node_features.shape
        x = batch.node_features
        flat_mask = batch.node_mask.reshape(B * n)
        for conv, norm in zip(self.convs, self.batch_norms):
            x = conv.forward_dense(x, batch.adj, self.compute_dtype)
            x = norm(x.reshape(B * n, -1), flat_mask).reshape(B, n, -1)
            if type(self)._relu_after_norm:
                x = torch.relu(x)
            x = self.dropout(x)
        m = batch.node_mask.to(x.dtype)[:, :, None]
        return (x * m).sum(dim=1) / (m.sum(dim=1) + 1e-8)

    def forward(self, batch: Batch) -> torch.Tensor:
        """Class logits ``[B, num_classes]``."""
        return self.classifier(self.encode(batch))


class GCNConnectome(_ConnectomeModel):
    """L-layer weighted GCN classifier: conv → BatchNorm → ReLU → dropout."""

    _conv = GCNConv
    _relu_after_norm = True


class GraphSAGEConnectome(_ConnectomeModel):
    """L-layer weighted GraphSAGE classifier: conv → BatchNorm → dropout."""

    _conv = SAGEConv
    _relu_after_norm = False
