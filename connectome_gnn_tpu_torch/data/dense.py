"""Dense block-diagonal batch layout: the fused-kernel serving path.

Connectome graphs are small (83-360 nodes) and moderately dense, so an
equal-size cohort packs as a dense ``[B, n, n]`` weighted adjacency and
aggregates with a batched product.  This is the layout the fused forward
kernels (:mod:`connectome_gnn_tpu_torch.ops.fused`) read.

Adjacency is stored **receiver-major**: ``adj[b, i, j]`` is the weight of
edge ``j → i``, so aggregation is ``adj @ x``.  Node padding is masked via
``node_mask [B, n]``; padded rows and columns carry zero weight and zero
features.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from connectome_gnn_tpu_torch.data.batch import _to, round_up
from connectome_gnn_tpu_torch.data.graph import ConnectomeGraph


@dataclasses.dataclass
class DenseConnectomeBatch:
    """A batch of equal-size graphs in dense adjacency form.

    Attributes
    ----------
    node_features : float32 [B, n, F]
    adj : float32 [B, n, n]
        Receiver-major weighted adjacency, no self-loops.
    node_mask : bool [B, n]
    labels : int64 [B]
    label_mask : bool [B]
    num_graphs : int
    """

    node_features: torch.Tensor
    adj: torch.Tensor
    node_mask: torch.Tensor
    labels: torch.Tensor
    label_mask: torch.Tensor
    num_graphs: int = 0

    @property
    def num_nodes(self) -> int:
        """Padded nodes per graph ``n``."""
        return int(self.node_features.shape[1])

    @property
    def num_features(self) -> int:
        return int(self.node_features.shape[2])

    @property
    def graph_mask(self) -> torch.Tensor:
        """bool [B]: True for real graph slots (labeled or not)."""
        return torch.any(self.node_mask, dim=-1)

    def to(self, device) -> "DenseConnectomeBatch":
        return _to(self, device)


def collate_dense(
    graphs: Sequence[ConnectomeGraph],
    *,
    num_graphs: Optional[int] = None,
    node_budget: Optional[int] = None,
    node_multiple: int = 8,
    num_features: Optional[int] = None,
    device=None,
) -> DenseConnectomeBatch:
    """Pack graphs into a :class:`DenseConnectomeBatch` on ``device``
    (default: the CPU).

    All graphs share one per-graph node budget (largest graph rounded up
    to ``node_multiple``).  Duplicate edges accumulate additively, matching
    COO scatter semantics: by the native helper
    (:func:`connectome_gnn_tpu_torch.native.dense_pack`) where it is built,
    else by ``np.add.at``, bitwise the same.
    """
    if len(graphs) == 0 and (num_graphs is None or num_features is None):
        raise ValueError(
            "collating an empty graph list requires num_graphs and num_features"
        )
    B = num_graphs if num_graphs is not None else len(graphs)
    if B < len(graphs):
        raise ValueError(f"num_graphs={B} < len(graphs)={len(graphs)}")

    max_nodes = max((g.num_nodes for g in graphs), default=0)
    n = node_budget if node_budget is not None else round_up(max_nodes, node_multiple)
    if n < max_nodes:
        raise ValueError(f"node_budget={n} < largest graph {max_nodes}")
    F = graphs[0].num_features if graphs else int(num_features)

    x = np.zeros((B, n, F), dtype=np.float32)
    adj = np.zeros((B, n, n), dtype=np.float32)
    node_mask = np.zeros((B, n), dtype=bool)
    labels = np.zeros(B, dtype=np.int64)
    label_mask = np.zeros(B, dtype=bool)

    from connectome_gnn_tpu_torch import native

    for b, g in enumerate(graphs):
        ng = g.num_nodes
        x[b, :ng] = g.node_features
        src, dst = g.edge_index
        if native.AVAILABLE:  # receiver-major
            native.dense_pack(src, dst, g.edge_weight, adj[b])
        else:
            np.add.at(adj[b], (dst, src), g.edge_weight)
        node_mask[b, :ng] = True
        if g.label is not None:
            labels[b] = int(g.label)
            label_mask[b] = True

    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return DenseConnectomeBatch(
        node_features=t(x),
        adj=t(adj),
        node_mask=t(node_mask),
        labels=t(labels),
        label_mask=t(label_mask),
        num_graphs=B,
    )
