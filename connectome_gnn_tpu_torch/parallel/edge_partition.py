"""Edge-partitioned giant-graph mode: one big graph sharded across devices.

The port of ``connectome_gnn_tpu/parallel/edge_partition.py``.  Nodes are
sharded contiguously (the id space padded to ``D · P_local``); every edge
goes to the shard that owns its receiver, receiver-sorted.  The boundary
exchange is a static send table, not an all-gather: for each ordered shard
pair ``(i → j)`` the unique sender rows ``j`` borrows from ``i`` are packed
host-side into ``send_idx [D, D, U]``; every layer ships exactly those rows
by one all-to-all (:func:`~connectome_gnn_tpu_torch.parallel.
hybrid_partition.exchange_rows`), and edges index a ``[local rows ‖
received rows]`` table through ``src_slot``.  Sender degrees are exact:
partial sums for borrowed rows return to their owners by the reverse
all-to-all (:func:`~connectome_gnn_tpu_torch.parallel.hybrid_partition.
reverse_scatter`).

:class:`EdgePartitionedGCN` / :class:`EdgePartitionedSAGE` are the node
models of this mode; their parameters are the COO node models'
(:class:`~connectome_gnn_tpu_torch.models.node_coo.NodeGCN` /
``NodeSAGE``), so the same weights run either way.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from connectome_gnn_tpu_torch.data.batch import round_up
from connectome_gnn_tpu_torch.data.graph import ConnectomeGraph
from connectome_gnn_tpu_torch.models.layers import EPS
from connectome_gnn_tpu_torch.models.node_coo import NodeGCN, NodeSAGE
from connectome_gnn_tpu_torch.parallel.hybrid_partition import (
    exchange_rows,
    remainder_table,
    reverse_scatter,
    stacked_gather,
    stacked_segment_sum,
)
from connectome_gnn_tpu_torch.parallel.mesh import Mesh
from connectome_gnn_tpu_torch.parallel.shard_forward import (
    ShardForwardMixin,
    make_node_train_step,
)


@dataclasses.dataclass
class PartitionedGraph:
    """A single giant graph, node- and edge-partitioned over ``D`` shards.

    Tensors carry the leading shard axis (all ``D`` shards, or a process's
    ``shard_range``).  Senders are addressed through ``src_slot``, an index
    into the per-shard ``[P_local local rows ‖ D·U received rows]`` table
    (slot ``P_local + i·U + u`` is the ``u``-th row borrowed from shard
    ``i``).  ``send_idx[i, j, u]`` is the local row (on shard ``i``) of the
    ``u``-th row shard ``j`` borrows from it; padding holds ``P_local``.
    Index tensors are int64; their values are the JAX package's int32.

    Attributes
    ----------
    node_features : float32 [D, P_local, F]
    src_slot : int64 [D, E_local]
    receivers : int64 [D, E_local]      local receiver ids
    edge_weight : float32 [D, E_local]  0 for padding
    send_idx : int64 [D, D, U]
    node_mask : bool [D, P_local]
    labels : int64 [D, P_local]         0 where unlabeled
    label_mask : bool [D, P_local]
    num_shards : int
    """

    node_features: torch.Tensor
    src_slot: torch.Tensor
    receivers: torch.Tensor
    edge_weight: torch.Tensor
    send_idx: torch.Tensor
    node_mask: torch.Tensor
    labels: torch.Tensor
    label_mask: torch.Tensor
    num_shards: int = 1

    @property
    def nodes_per_shard(self) -> int:
        return int(self.node_features.shape[1])

    @property
    def total_nodes(self) -> int:
        return self.num_shards * self.nodes_per_shard

    @property
    def borrowed_rows(self) -> int:
        """The static per-pair borrowed-row budget ``U``."""
        return int(self.send_idx.shape[-1])


def partition_graph(
    graph: ConnectomeGraph,
    num_shards: int,
    *,
    node_labels: Optional[np.ndarray] = None,
    node_multiple: int = 8,
    edge_multiple: int = 128,
    slot_multiple: int = 8,
    shard_range: Optional[tuple[int, int]] = None,
) -> PartitionedGraph:
    """Partition one graph on the host (``edge_partition.py:111``), bitwise
    the JAX package's partition.

    Nodes split into ``num_shards`` contiguous blocks; edges go to the
    shard of their receiver, senders resolved to slot indices, and each
    ordered pair's unique borrowed rows packed into ``send_idx``.
    ``shard_range=(lo, hi)`` materializes only shards ``[lo, hi)`` (a
    process's part); paddings and the send table's metadata stay global,
    so every process gets the same shapes.
    """
    n = graph.num_nodes
    p_local = round_up(-(-n // num_shards), node_multiple)
    D = num_shards
    lo, hi = shard_range if shard_range is not None else (0, D)
    if not 0 <= lo < hi <= D:
        raise ValueError(f"bad shard_range {(lo, hi)} for D={D}")
    d_here = hi - lo

    src = graph.edge_index[0].astype(np.int64)
    dst = graph.edge_index[1].astype(np.int64)
    w = graph.edge_weight
    d_r, r_loc = dst // p_local, dst % p_local
    d_s, s_loc = src // p_local, src % p_local

    counts = np.bincount(d_r, minlength=D)
    e_local = round_up(int(counts.max()) if counts.size else 1, edge_multiple)

    # pass 1: unique borrowed rows per ordered pair (i → j), global: every
    # process needs the whole table to resolve its own slots
    uniques: list[list[np.ndarray]] = [[np.empty(0, np.int64)] * D for _ in range(D)]
    for j in range(D):
        mask_j = d_r == j
        for i in range(D):
            if i == j:
                continue
            uniques[i][j] = np.unique(s_loc[mask_j & (d_s == i)])
    max_u = max((len(u) for row in uniques for u in row), default=0)
    U = max(slot_multiple, -(-max_u // slot_multiple) * slot_multiple)

    send_idx = np.full((d_here, D, U), p_local, np.int64)
    for i in range(lo, hi):
        for j in range(D):
            rows = uniques[i][j]
            send_idx[i - lo, j, : len(rows)] = rows

    # pass 2: per-shard edge arrays with slot-resolved senders
    F = graph.num_features
    src_slot = np.zeros((d_here, e_local), np.int64)
    receivers = np.zeros((d_here, e_local), np.int64)
    weights = np.zeros((d_here, e_local), np.float32)
    labels = np.zeros((d_here, p_local), np.int64)
    label_mask = np.zeros((d_here, p_local), bool)

    def slab(flat):
        """Rows ``[lo·p_local, hi·p_local)`` of the padded node space."""
        a, b = lo * p_local, hi * p_local
        out = np.zeros((b - a,) + flat.shape[1:], flat.dtype)
        if a < n:
            out[: min(b, n) - a] = flat[a : min(b, n)]
        return out.reshape((d_here, p_local) + flat.shape[1:])

    x = slab(np.asarray(graph.node_features, np.float32)).reshape(d_here, p_local, F)
    node_mask = slab(np.ones(n, bool))
    if node_labels is not None:
        labels[:] = slab(np.asarray(node_labels, np.int64))
        label_mask[:] = node_mask

    for j in range(lo, hi):
        mask_j = d_r == j
        rj, wj = r_loc[mask_j], w[mask_j]
        sj_shard, sj_loc = d_s[mask_j], s_loc[mask_j]
        slot = np.empty(len(rj), np.int64)
        local = sj_shard == j
        slot[local] = sj_loc[local]
        for i in range(D):
            if i == j:
                continue
            m = sj_shard == i
            if not m.any():
                continue
            slot[m] = p_local + i * U + np.searchsorted(uniques[i][j], sj_loc[m])
        # receiver-sorted within the shard (stable, so deterministic)
        order = np.argsort(rj, kind="stable")
        e = len(rj)
        src_slot[j - lo, :e] = slot[order]
        receivers[j - lo, :e] = rj[order]
        weights[j - lo, :e] = wj[order]

    t = torch.from_numpy
    return PartitionedGraph(
        node_features=t(x), src_slot=t(src_slot), receivers=t(receivers), edge_weight=t(weights),
        send_idx=t(send_idx), node_mask=t(node_mask), labels=t(labels),
        label_mask=t(label_mask), num_shards=D,
    )


def partitioned_normalization(shard: PartitionedGraph, mesh: Mesh, axis_name: str):
    """Exact GCN symmetric normalization over the partitioned layout
    (``edge_partition.py:229``): ``(w_norm [S, E], self_norm [S, P])``,
    the per-edge and self-loop factors of ``gcn_normalize`` (self-loop
    weight 1, the reference's epsilon).  Layer-invariant."""
    S, p_local = shard.node_features.shape[:2]
    n_slots = p_local + shard.send_idx[0].numel()
    # sender degrees in slot space; borrowed partials go home by the
    # reverse all-to-all
    contrib = stacked_segment_sum(shard.edge_weight, shard.src_slot, n_slots)
    deg = contrib[:, :p_local] + reverse_scatter(
        contrib[:, p_local:].reshape(shard.send_idx.shape), shard.send_idx, p_local, mesh,
        axis_name,
    )
    dinv = torch.rsqrt(deg + 1.0 + EPS)
    dinv_table = torch.cat(
        [dinv, exchange_rows(dinv, shard.send_idx, mesh, axis_name).reshape(S, -1)], dim=1)
    w_norm = (stacked_gather(dinv_table, shard.src_slot) * shard.edge_weight
              * stacked_gather(dinv, shard.receivers))
    return w_norm, dinv * dinv


def partitioned_gcn_layer(conv, x: torch.Tensor, shard: PartitionedGraph, mesh: Mesh,
                          axis_name: str, *, w_norm=None, self_norm=None) -> torch.Tensor:
    """One GCN convolution over the partitioned layout
    (``edge_partition.py:264``): the dense ``xW`` on local rows, one
    all-to-all of its borrowed rows (width ``H``, never raw features), the
    weighted aggregation into local receivers, the self loop and the bias.
    ``x [S, P, F]`` → ``[S, P, H]``."""
    if w_norm is None or self_norm is None:
        w_norm, self_norm = partitioned_normalization(shard, mesh, axis_name)
    xw = conv.linear(x)
    table = remainder_table(xw, shard.send_idx, mesh, axis_name)
    msg = stacked_gather(table, shard.src_slot) * w_norm[..., None]
    out = stacked_segment_sum(msg, shard.receivers, x.shape[1])
    return out + self_norm[..., None] * xw + conv.bias


def partitioned_sage_layer(conv, x: torch.Tensor, shard: PartitionedGraph, mesh: Mesh,
                           axis_name: str) -> torch.Tensor:
    """One SAGE convolution over the partitioned layout
    (``edge_partition.py:295``): the mean normalizer is the receivers'
    weight sum, all local; the borrowed rows of ``x`` itself cross shards
    (SAGE concatenates before its projection)."""
    p_local = x.shape[1]
    w_sum = stacked_segment_sum(shard.edge_weight, shard.receivers, p_local)
    table = remainder_table(x, shard.send_idx, mesh, axis_name)
    msg = stacked_gather(table, shard.src_slot) * shard.edge_weight[..., None]
    agg = stacked_segment_sum(msg, shard.receivers, p_local) / (w_sum + EPS)[..., None]
    return torch.relu(conv.linear(torch.cat([x, agg], dim=-1)))


class _EdgePartitioned(ShardForwardMixin):
    """L partitioned convolutions, sync-BatchNorm across shards, a
    per-node linear head (no pooling)."""

    def apply_shard(self, shard: PartitionedGraph, mesh: Mesh, *, axis_name: str) -> torch.Tensor:
        """Per-node logits ``[S, P, C]`` of the rank's shards, in the
        module's mode (train mode updates the BatchNorm moments)."""
        x = shard.node_features
        norm = partitioned_normalization(shard, mesh, axis_name) if self._needs_norm else None
        mask = shard.node_mask.reshape(-1)
        for conv, bn in zip(self.convs, self.batch_norms):
            x = self._layer(conv, x, shard, mesh, axis_name, norm)
            S, P, H = x.shape
            x = bn(x.reshape(S * P, H), mask)
            if self.relu_after_norm:
                x = torch.relu(x)
            x = self.dropout(x).view(S, P, H)
        return self.head(x)


class EdgePartitionedGCN(_EdgePartitioned, NodeGCN):
    """Node-level GCN over an edge-partitioned giant graph; the parameters
    of :class:`~connectome_gnn_tpu_torch.models.node_coo.NodeGCN`."""

    _needs_norm = True

    def __init__(self, in_channels: int, hidden_dim: int = 64, num_classes: int = 2,
                 num_layers: int = 3, dropout: float = 0.0, *, generator=None):
        super().__init__(in_channels, hidden_dim, num_classes, num_layers, dropout,
                         generator=generator)

    def _layer(self, conv, x, shard, mesh, axis_name, norm):
        return partitioned_gcn_layer(conv, x, shard, mesh, axis_name, w_norm=norm[0],
                                     self_norm=norm[1])


class EdgePartitionedSAGE(_EdgePartitioned, NodeSAGE):
    """Node-level GraphSAGE over an edge-partitioned giant graph (ReLU inside
    the layer, none after the BatchNorm); the parameters of ``NodeSAGE``."""

    _needs_norm = False

    def __init__(self, in_channels: int, hidden_dim: int = 64, num_classes: int = 2,
                 num_layers: int = 3, dropout: float = 0.0, *, generator=None):
        super().__init__(in_channels, hidden_dim, num_classes, num_layers, dropout,
                         generator=generator)

    def _layer(self, conv, x, shard, mesh, axis_name, norm):
        return partitioned_sage_layer(conv, x, shard, mesh, axis_name)


def make_partitioned_train_step(model: _EdgePartitioned, optimizer, mesh: Mesh,
                                axis_name: str = "edge", seed: int = 0):
    """A node-classification train step over a partitioned graph
    (``edge_partition.py:429``): ``step(pgraph) -> (loss, n)``, the masked
    mean cross-entropy over every shard's labelled nodes, the model and
    optimizer updated in place by the gradient rule of
    :mod:`~connectome_gnn_tpu_torch.parallel.shard_forward`, on a 1-D
    mesh; dropout draws per shard from generators seeded from ``seed``."""
    if mesh.axis_names != (axis_name,):
        raise ValueError(f"make_partitioned_train_step runs on a mesh with axes {(axis_name,)}, "
                         f"not {mesh.axis_names}")
    return make_node_train_step(model, optimizer, mesh, axis_name, seed)
