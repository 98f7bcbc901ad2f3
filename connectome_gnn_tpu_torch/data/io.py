"""Dataset persistence and real-data ingestion (host side).

The port of ``connectome_gnn_tpu/data/io.py``, numpy only and bitwise the
JAX package's:

* :func:`graph_from_adjacency` — dense ``[N, N]`` connectivity matrix →
  :class:`ConnectomeGraph` (COO, both directions for a symmetric matrix,
  the diagonal dropped);
* :func:`save_dataset` / :func:`load_dataset` — ragged graph lists
  round-tripped through one ``.npz`` (concatenated arrays + offsets), no
  pickle.  The file's keys and dtypes are the JAX package's, so a file
  written by either package loads in the other.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from connectome_gnn_tpu_torch.data.graph import ConnectomeGraph


def graph_from_adjacency(
    adjacency: np.ndarray,
    node_features: Optional[np.ndarray] = None,
    label: Optional[int] = None,
    subject_id: str = "unknown",
    threshold: float = 0.0,
) -> ConnectomeGraph:
    """Build a graph from a dense connectivity matrix.

    Entries with ``|w| <= threshold`` and the diagonal are dropped; each
    surviving entry ``A[i, j]`` becomes the directed edge ``i → j``, in
    ``np.nonzero`` order (pass a symmetric matrix for an undirected
    connectome: both directions are then present, the generator's
    convention).

    Default node features (when none are given): the weighted out-degree
    normalized by its largest value, the reference's minimal-feature mode.
    """
    A = np.asarray(adjacency, np.float32)
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"adjacency must be square, got {A.shape}")
    n = A.shape[0]
    mask = np.abs(A) > threshold
    np.fill_diagonal(mask, False)
    src, dst = np.nonzero(mask)
    weights = A[src, dst]

    if node_features is None:
        deg = np.zeros(n, np.float32)
        np.add.at(deg, src, weights)
        node_features = (deg / (deg.max() + 1e-8))[:, None]

    return ConnectomeGraph(
        node_features=np.asarray(node_features, np.float32),
        edge_index=np.stack([src, dst]).astype(np.int32),
        edge_weight=weights.astype(np.float32),
        label=label,
        subject_id=subject_id,
    )


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_dataset(path: str, graphs: Sequence[ConnectomeGraph]) -> None:
    """Save a ragged list of graphs to one ``.npz`` (``.npz`` is appended
    to a path without it).  Labels are stored as int64, ``-1`` for none."""
    node_ptr = np.cumsum([0] + [g.num_nodes for g in graphs])
    edge_ptr = np.cumsum([0] + [g.num_edges for g in graphs])
    labels = np.array([g.label if g.label is not None else -1 for g in graphs], np.int64)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(
        _npz_path(path),
        node_features=np.concatenate([g.node_features for g in graphs]),
        edge_index=np.concatenate([g.edge_index for g in graphs], axis=1),
        edge_weight=np.concatenate([g.edge_weight for g in graphs]),
        node_ptr=node_ptr,
        edge_ptr=edge_ptr,
        labels=labels,
        subject_ids=np.array([g.subject_id for g in graphs]),
    )


def load_dataset(path: str) -> list[ConnectomeGraph]:
    """Load a dataset saved by :func:`save_dataset` (of either package)."""
    with np.load(_npz_path(path), allow_pickle=False) as data:
        node_ptr = data["node_ptr"]
        edge_ptr = data["edge_ptr"]
        labels = data["labels"]
        subject_ids = data["subject_ids"]
        node_features = data["node_features"]
        edge_index = data["edge_index"]
        edge_weight = data["edge_weight"]
    graphs = []
    for i in range(len(node_ptr) - 1):
        n0, n1 = int(node_ptr[i]), int(node_ptr[i + 1])
        e0, e1 = int(edge_ptr[i]), int(edge_ptr[i + 1])
        label = int(labels[i])
        graphs.append(
            ConnectomeGraph(
                node_features=node_features[n0:n1],
                edge_index=edge_index[:, e0:e1],
                edge_weight=edge_weight[e0:e1],
                label=None if label < 0 else label,
                subject_id=str(subject_ids[i]),
            )
        )
    return graphs
