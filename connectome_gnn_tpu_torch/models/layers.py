"""Message-passing layers: GCN and GraphSAGE convolutions.

Each layer takes either the padded COO batch layout (:meth:`forward`) or
the dense receiver-major ``[B, n, n]`` adjacency (:meth:`forward_dense`),
with identical numerics.  Numeric contract (reference
``connectome_gnn/models.py``, as in ``connectome_gnn_tpu.models.layers``):

* :class:`GCNConv`: ``H' = D̂^{-1/2} Â D̂^{-1/2} (H W) + b`` with self-loop
  weight 1.0, Xavier-uniform kernel, zero bias added after aggregation.
* :class:`SAGEConv`: weighted-mean neighbour aggregation, concat with the
  self features, one linear + ReLU; Xavier kernel, torch-default bias, no
  self-loops.

Both use the ``+1e-8`` epsilon denominators of the reference.  Parameter
names follow the reference's ``state_dict`` (``linear.weight``, GCN
``bias``, SAGE ``linear.bias``).
"""

from __future__ import annotations

import torch
from torch import nn

from connectome_gnn_tpu_torch.nn.initializers import xavier_uniform
from connectome_gnn_tpu_torch.nn.layers import Dense
from connectome_gnn_tpu_torch.ops.gcn_norm import gcn_normalize
from connectome_gnn_tpu_torch.ops.segment import coo_spmm, segment_sum

EPS = 1e-8


class GCNConv(nn.Module):
    """Symmetric-normalized weighted graph convolution."""

    def __init__(self, in_channels: int, out_channels: int, *, generator: torch.Generator):
        super().__init__()
        self.linear = Dense(
            in_channels, out_channels, generator=generator, bias=False,
            kernel_init=xavier_uniform,
        )
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(
        self,
        x: torch.Tensor,
        senders: torch.Tensor,
        receivers: torch.Tensor,
        edge_weight: torch.Tensor,
    ) -> torch.Tensor:
        """COO layout: transform, then gather-scale-segment-sum, with the
        self-loop block as an elementwise rescale."""
        num_nodes = x.shape[0]
        norm = gcn_normalize(senders, receivers, edge_weight, num_nodes)
        xw = self.linear(x)
        out = coo_spmm(norm.edge_norm, senders, receivers, xw, num_nodes)
        out = out + norm.self_norm[:, None] * xw
        return out + self.bias

    def forward_dense(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        """Dense layout ``x [B, n, F]``, ``adj [B, n, n]``.  The degree of
        sender j is the column sum over receivers i, plus the self-loop."""
        deg = adj.sum(dim=1) + 1.0
        dinv = torch.rsqrt(deg + EPS)  # [B, n]
        adj_norm = dinv[:, :, None] * adj * dinv[:, None, :]
        xw = self.linear(x)
        out = torch.matmul(adj_norm, xw) + (dinv * dinv)[:, :, None] * xw
        return out + self.bias


class SAGEConv(nn.Module):
    """Weighted-mean aggregate → concat(self, agg) → linear → ReLU."""

    def __init__(self, in_channels: int, out_channels: int, *, generator: torch.Generator):
        super().__init__()
        self.linear = Dense(
            2 * in_channels, out_channels, generator=generator,
            kernel_init=xavier_uniform,
        )

    def forward(
        self,
        x: torch.Tensor,
        senders: torch.Tensor,
        receivers: torch.Tensor,
        edge_weight: torch.Tensor,
    ) -> torch.Tensor:
        num_nodes = x.shape[0]
        msg_sum = coo_spmm(edge_weight, senders, receivers, x, num_nodes)
        w_sum = segment_sum(edge_weight[:, None], receivers, num_nodes)
        agg = msg_sum / (w_sum + EPS)
        return torch.relu(self.linear(torch.cat([x, agg], dim=1)))

    def forward_dense(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        """Dense layout: the weight sum is a row sum (receiver-major)."""
        msg_sum = torch.matmul(adj, x)
        w_sum = adj.sum(dim=-1, keepdim=True)
        agg = msg_sum / (w_sum + EPS)
        return torch.relu(self.linear(torch.cat([x, agg], dim=-1)))
