"""Padded, statically-shaped batch container (device side).

Nodes and edges of a batch are concatenated block-diagonally, padded to
fixed budgets with explicit masks, and edges are sorted by receiver (CSR
order), exactly as in ``connectome_gnn_tpu.data.batch``: the arrays are
built in numpy by the same code and only then become torch tensors on the
requested device, so both packages see bitwise-equal batches.

Padding is inert by construction: padded edges have weight 0 and point
one past the end (id ``P``), padded nodes have zero features and graph id
``num_graphs`` (one past the last real segment), and padded graph slots
are masked out of loss and metrics via ``label_mask``.  Torch's
``index_add_`` and indexing raise on those out-of-range ids where JAX drops
or clamps them, so the consumers in :mod:`connectome_gnn_tpu_torch.ops`
drop and clamp them explicitly.

Index tensors are ``int64`` (torch's index type); their values equal the
JAX package's ``int32`` arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from connectome_gnn_tpu_torch.data.graph import ConnectomeGraph


def round_up(value: int, multiple: int) -> int:
    """Round ``value`` up to the nearest positive multiple of ``multiple``."""
    if multiple <= 1:
        return max(value, 1)
    return max(((value + multiple - 1) // multiple) * multiple, multiple)


def to_device(batch, device=None):
    """Copy of a batch (:class:`ConnectomeBatch` or ``DenseConnectomeBatch``)
    with every tensor moved to ``device``, the analog of JAX's
    ``to_device`` (``connectome_gnn_tpu/data/batch.py:237-251``).

    ``device`` defaults to ``cuda``; without a CUDA card that raises
    ``RuntimeError`` (pass ``device="cpu"`` for the CPU).
    """
    return _to(batch, card_by_default(device, "to_device"))


def card_by_default(device, caller: str):
    """``device``, or ``"cuda"`` when it is ``None``: the port's entry
    points run on the card unless asked for the CPU.  Raises
    ``RuntimeError`` when ``device`` is ``None`` and no CUDA card is
    available."""
    if device is not None:
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            f'{caller} runs on the CUDA card by default and none is available; pass device="cpu"'
        )
    return "cuda"


def _to(batch, device):
    """Copy of a batch dataclass with every tensor field moved to ``device``."""
    return dataclasses.replace(
        batch,
        **{
            f.name: getattr(batch, f.name).to(device)
            for f in dataclasses.fields(batch)
            if isinstance(getattr(batch, f.name), torch.Tensor)
        },
    )


@dataclasses.dataclass
class ConnectomeBatch:
    """A padded block-diagonal batch of connectome graphs.

    Shapes: ``P`` = padded node count, ``Q`` = padded edge count, ``B`` =
    graph slots (including padded slots).

    Attributes
    ----------
    node_features : float32 [P, F]
    senders / receivers : int64 [Q]
        COO endpoints, offset per graph, sorted by receiver.  Padded edges
        hold id ``P`` and weight 0.
    edge_weight : float32 [Q]
    node_graph_ids : int64 [P]
        Graph index per node; padding rows hold ``num_graphs``.
    node_mask : bool [P]
    edge_mask : bool [Q]
    labels : int64 [B]
        0 for padded or unlabeled slots.
    label_mask : bool [B]
        True for real, labeled graphs.
    ptr : int64 [B + 1]
        Cumulative real-node counts per graph.
    row_ptr : int64 [P + 1]
        CSR indptr over receivers (real edges only).
    num_graphs : int
        Number of graph slots ``B``.
    """

    node_features: torch.Tensor
    senders: torch.Tensor
    receivers: torch.Tensor
    edge_weight: torch.Tensor
    node_graph_ids: torch.Tensor
    node_mask: torch.Tensor
    edge_mask: torch.Tensor
    labels: torch.Tensor
    label_mask: torch.Tensor
    ptr: torch.Tensor
    row_ptr: torch.Tensor
    num_graphs: int = 0

    @property
    def num_nodes(self) -> int:
        """Padded node count ``P``."""
        return int(self.node_features.shape[0])

    @property
    def num_edges(self) -> int:
        """Padded edge count ``Q``."""
        return int(self.senders.shape[0])

    @property
    def num_features(self) -> int:
        return int(self.node_features.shape[1])

    @property
    def edge_index(self) -> torch.Tensor:
        """COO [2, Q] view, mirroring the reference field layout."""
        return torch.stack([self.senders, self.receivers], dim=0)

    @property
    def graph_mask(self) -> torch.Tensor:
        """bool [B]: True for real graph slots (labeled or not)."""
        return torch.diff(self.ptr) > 0

    def to(self, device) -> "ConnectomeBatch":
        return _to(self, device)


def collate_graphs(
    graphs: Sequence[ConnectomeGraph],
    *,
    num_graphs: Optional[int] = None,
    node_budget: Optional[int] = None,
    edge_budget: Optional[int] = None,
    node_multiple: int = 8,
    edge_multiple: int = 128,
    num_features: Optional[int] = None,
    device=None,
) -> ConnectomeBatch:
    """Pack graphs into a padded block-diagonal :class:`ConnectomeBatch`
    on ``device`` (default: the CPU).

    Same semantics and arguments as ``connectome_gnn_tpu.data.batch.
    collate_graphs``: ``num_graphs`` slots (extra slots are empty padded
    graphs), ``node_budget`` / ``edge_budget`` static padded sizes
    (default: totals rounded up to the multiples), ``num_features`` needed
    only for an empty graph list.
    """
    if len(graphs) == 0 and (num_graphs is None or num_features is None):
        raise ValueError(
            "collating an empty graph list requires num_graphs and num_features"
        )
    B = num_graphs if num_graphs is not None else len(graphs)
    if B < len(graphs):
        raise ValueError(f"num_graphs={B} < len(graphs)={len(graphs)}")

    total_nodes = sum(g.num_nodes for g in graphs)
    total_edges = sum(g.num_edges for g in graphs)
    P = node_budget if node_budget is not None else round_up(total_nodes, node_multiple)
    Q = edge_budget if edge_budget is not None else round_up(total_edges, edge_multiple)
    if P < total_nodes:
        raise ValueError(f"node_budget={P} < total nodes {total_nodes}")
    if Q < total_edges:
        raise ValueError(f"edge_budget={Q} < total edges {total_edges}")

    F = graphs[0].num_features if graphs else int(num_features)
    node_features = np.zeros((P, F), dtype=np.float32)
    # padded edges point one past the end, so the receiver array stays
    # non-decreasing after the CSR sort
    senders = np.full(Q, P, dtype=np.int64)
    receivers = np.full(Q, P, dtype=np.int64)
    edge_weight = np.zeros(Q, dtype=np.float32)
    node_graph_ids = np.full(P, B, dtype=np.int64)
    node_mask = np.zeros(P, dtype=bool)
    edge_mask = np.zeros(Q, dtype=bool)
    labels = np.zeros(B, dtype=np.int64)
    label_mask = np.zeros(B, dtype=bool)
    ptr = np.zeros(B + 1, dtype=np.int64)

    node_off = 0
    edge_off = 0
    for g_idx, g in enumerate(graphs):
        n, e = g.num_nodes, g.num_edges
        node_features[node_off : node_off + n] = g.node_features
        senders[edge_off : edge_off + e] = g.edge_index[0] + node_off
        receivers[edge_off : edge_off + e] = g.edge_index[1] + node_off
        edge_weight[edge_off : edge_off + e] = g.edge_weight
        node_graph_ids[node_off : node_off + n] = g_idx
        node_mask[node_off : node_off + n] = True
        edge_mask[edge_off : edge_off + e] = True
        if g.label is not None:
            labels[g_idx] = int(g.label)
            label_mask[g_idx] = True
        node_off += n
        edge_off += e
        ptr[g_idx + 1] = node_off
    ptr[len(graphs) + 1 :] = node_off

    order = np.argsort(receivers, kind="stable")
    senders = senders[order]
    receivers = receivers[order]
    edge_weight = edge_weight[order]
    edge_mask = edge_mask[order]

    counts = np.bincount(receivers[edge_mask], minlength=P)
    row_ptr = np.zeros(P + 1, dtype=np.int64)
    row_ptr[1:] = np.cumsum(counts)

    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return ConnectomeBatch(
        node_features=t(node_features),
        senders=t(senders),
        receivers=t(receivers),
        edge_weight=t(edge_weight),
        node_graph_ids=t(node_graph_ids),
        node_mask=t(node_mask),
        edge_mask=t(edge_mask),
        labels=t(labels),
        label_mask=t(label_mask),
        ptr=t(ptr),
        row_ptr=t(row_ptr),
        num_graphs=B,
    )
