"""GCN symmetric normalization over a padded COO edge list.

Same factors as ``connectome_gnn_tpu.ops.gcn_norm.gcn_normalize``
(reference ``connectome_gnn/models.py:94-108``):

    Â = A_w + I                      (self-loops, weight 1.0)
    d_j = Σ_i Â_ij                   (weighted degree over senders)
    ŵ_ij = d_i^{-1/2} · Â_ij · d_j^{-1/2}

The self-loop block (weight 1.0) is folded out algebraically: the degree
gets one 1.0 per node and the self-loop term is the per-node coefficient
``self_norm``.  Padded edges (id ``P``, weight 0) are dropped
from the degree by :func:`segment_sum` and clamped for the gathers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from connectome_gnn_tpu_torch.ops.segment import segment_sum

EPS = 1e-8


class GCNNorm(NamedTuple):
    """``edge_norm [Q]`` normalized off-diagonal weights, ``self_norm [P]``
    self-loop coefficients, ``deg_inv_sqrt [P]``."""

    edge_norm: torch.Tensor
    self_norm: torch.Tensor
    deg_inv_sqrt: torch.Tensor


def gcn_normalize(
    senders: torch.Tensor,
    receivers: torch.Tensor,
    edge_weight: torch.Tensor,
    num_nodes: int,
    *,
    self_loop_weight: float = 1.0,
    eps: float = EPS,
) -> GCNNorm:
    """Self-loop-augmented symmetric normalization factors: the degree over
    senders plus ``self_loop_weight``, ``(deg + eps)^-1/2``, and the
    self-loop coefficient ``d^-1/2 · self_loop_weight · d^-1/2``."""
    deg = segment_sum(edge_weight, senders, num_nodes) + self_loop_weight
    deg_inv_sqrt = torch.rsqrt(deg + eps)
    last = num_nodes - 1
    edge_norm = (
        deg_inv_sqrt[senders.clamp(0, last)]
        * edge_weight
        * deg_inv_sqrt[receivers.clamp(0, last)]
    )
    self_norm = deg_inv_sqrt * deg_inv_sqrt * self_loop_weight
    return GCNNorm(edge_norm, self_norm, deg_inv_sqrt)
