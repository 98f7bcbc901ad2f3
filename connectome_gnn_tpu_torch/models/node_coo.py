"""Node-level COO classifiers for sampled (and full-batch) giant graphs.

The port of ``connectome_gnn_tpu/models/node_coo.py``.  ``NodeGCN`` and
``NodeSAGE`` run the graph-level models' convolution stacks over a
:class:`~connectome_gnn_tpu_torch.data.sampled.SampledNodeBatch`, with a
per-node linear head read at the ``num_seeds`` seed slots only: the
seed-supervised objective of GraphSAGE-style minibatch training.  Calling
the model on a batch returns per-seed logits ``[S, C]`` against the batch's
``labels`` / ``label_mask``, so :class:`~connectome_gnn_tpu_torch.train.
Trainer` drives sampled training and evaluation unchanged.  Over
:func:`~connectome_gnn_tpu_torch.data.sampled.full_graph_batch` the same
model is the full-batch oracle.

The parameter names are :class:`~connectome_gnn_tpu_torch.models.node_gcn.
BandedNodeGCN`'s and ``BandedNodeSAGE``'s (``convs.i``, ``batch_norms.i``,
``head``), and the weights are drawn in the same order, so checkpoints move
between the COO and banded node families, as the JAX package's shared
``init_node_gcn_params`` / ``init_node_sage_params`` let them.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from connectome_gnn_tpu_torch.models.layers import GCNConv, SAGEConv
from connectome_gnn_tpu_torch.nn.layers import Dense, Dropout, MaskedBatchNorm


class _NodeModel(nn.Module):
    """L convolutions, each followed by masked BatchNorm, ReLU (GCN only)
    and dropout, then a per-node head read at the seed slots.

    ``Blocked*`` subclasses aggregate through the device sampler's
    per-hop ``hop_blocks`` when the batch carries them (row sums and a
    frontier-count scatter instead of an edge-count scatter), else through
    the flat COO edges.  Same parameters, the same math up to the order of
    float32 sums.
    """

    conv_class: type
    relu_after_norm: bool
    blocked = False

    def __init__(
        self,
        in_channels: int,
        hidden_dim: int = 64,
        num_classes: int = 2,
        num_layers: int = 2,
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
            self.conv_class(dims[i], dims[i + 1], generator=generator) for i in range(self.num_layers)
        )
        self.batch_norms = nn.ModuleList(
            MaskedBatchNorm(self.hidden_dim) for _ in range(self.num_layers)
        )
        self.head = Dense(self.hidden_dim, self.num_classes, generator=generator)
        self.dropout = Dropout(dropout)

    def forward(self, batch) -> torch.Tensor:
        """Per-seed logits ``[num_seeds, C]`` in float32."""
        blocked = self.blocked and batch.hop_blocks is not None
        x = batch.node_features
        for conv, norm in zip(self.convs, self.batch_norms):
            if blocked:
                x = conv.forward_blocked(x, batch.hop_blocks, batch.num_seeds)
            else:
                x = conv(x, batch.senders, batch.receivers, batch.edge_weight)
            x = norm(x, batch.node_mask)
            if self.relu_after_norm:
                x = torch.relu(x)
            x = self.dropout(x, getattr(batch, "shard_regions", None))
        return self.head(x[: batch.num_seeds])


class NodeGCN(_NodeModel):
    """L-layer node-classification GCN over sampled or full COO batches:
    :class:`GCNConnectome`'s layer (sym-norm conv, BatchNorm, ReLU,
    dropout), a per-node linear head at the seeds."""

    conv_class = GCNConv
    relu_after_norm = True


class BlockedNodeGCN(NodeGCN):
    """:class:`NodeGCN` that aggregates through the device sampler's
    per-hop blocks when the batch carries them; checkpoints are
    interchangeable with :class:`NodeGCN`."""

    blocked = True


class NodeSAGE(_NodeModel):
    """L-layer node-classification GraphSAGE (ReLU inside the layer, none
    after the BatchNorm: the reference asymmetry).

    ``multiset_safe``: SAGE's aggregation is a receiver-side weighted mean,
    which duplicated sender slots of the multiset sampler do not change;
    GCN's sender-degree normalization does change, so it lacks the marker.
    """

    conv_class = SAGEConv
    relu_after_norm = False
    multiset_safe = True


class BlockedNodeSAGE(NodeSAGE):
    """:class:`NodeSAGE` that aggregates through the device sampler's
    per-hop blocks when the batch carries them; checkpoints are
    interchangeable with :class:`NodeSAGE`."""

    blocked = True
