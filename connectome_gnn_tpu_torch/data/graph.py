"""Connectome graph container (host side).

A brain connectome is a weighted undirected graph: nodes are brain regions
(ROIs) with feature vectors, edges carry connectivity weights, and the graph
has an optional scalar label.  ``ConnectomeGraph`` is the *host-side*
per-subject container (numpy arrays): ragged, cheap, and mutated freely
during data prep.  Device residency, static shapes, and padding live one
level up in :mod:`connectome_gnn_tpu_torch.data.batch` — that separation is
what keeps every batch statically shaped while the data layer stays
ragged-friendly.

API parity: mirrors the reference ``ConnectomeGraph``
(reference ``connectome_gnn/graph.py:27-94``): COO ``edge_index [2, E]`` with
both directions stored for undirected graphs, ``edge_weight [E]``,
``node_features [N, F]``, plus ``adjacency_matrix()`` / ``degree()`` helpers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class ConnectomeGraph:
    """A single subject's brain connectivity graph (host-side, numpy).

    Attributes
    ----------
    node_features : float32 [N, F]
        Per-region feature matrix.
    edge_index : int32 [2, E]
        COO edge list; undirected edges appear once per direction.
    edge_weight : float32 [E]
        Connectivity weight per directed edge.
    label : optional int
        Graph-level class label.
    subject_id : str
        Subject identifier.
    """

    node_features: np.ndarray
    edge_index: np.ndarray
    edge_weight: np.ndarray
    label: Optional[int] = None
    subject_id: str = "unknown"

    def __post_init__(self) -> None:
        self.node_features = np.asarray(self.node_features, dtype=np.float32)
        self.edge_index = np.asarray(self.edge_index, dtype=np.int32)
        self.edge_weight = np.asarray(self.edge_weight, dtype=np.float32)
        if self.edge_index.ndim != 2 or self.edge_index.shape[0] != 2:
            raise ValueError(
                f"edge_index must be [2, E], got {self.edge_index.shape}"
            )
        if self.edge_weight.shape[0] != self.edge_index.shape[1]:
            raise ValueError(
                "edge_weight length "
                f"{self.edge_weight.shape[0]} != num edges {self.edge_index.shape[1]}"
            )

    # ------------------------------------------------------------------
    # Shape properties
    # ------------------------------------------------------------------

    @property
    def num_nodes(self) -> int:
        return int(self.node_features.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.edge_index.shape[1])

    @property
    def num_features(self) -> int:
        return int(self.node_features.shape[1])

    # ------------------------------------------------------------------
    # Helpers
    # ------------------------------------------------------------------

    def adjacency_matrix(self) -> np.ndarray:
        """Dense [N, N] weighted adjacency matrix."""
        n = self.num_nodes
        A = np.zeros((n, n), dtype=self.edge_weight.dtype)
        src, dst = self.edge_index
        A[src, dst] = self.edge_weight
        return A

    def degree(self) -> np.ndarray:
        """Weighted out-degree vector [N] (sum of outgoing edge weights)."""
        deg = np.zeros(self.num_nodes, dtype=self.edge_weight.dtype)
        np.add.at(deg, self.edge_index[0], self.edge_weight)
        return deg
