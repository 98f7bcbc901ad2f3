"""Graph reordering for bandwidth reduction (host side, numpy).

The port of ``connectome_gnn_tpu/data/reorder.py``'s Reverse-Cuthill-McKee
path.  The banded SpMM (:mod:`connectome_gnn_tpu_torch.ops.banded`) needs
node orderings where edges connect nearby indices; RCM (BFS from a
low-degree node, neighbours visited degree-ascending, order reversed)
recovers them at O(N + E) cost.  The permutation equals the JAX package's:
it runs the same numpy BFS, which the JAX package's native helper matches
bitwise.

Waiting for later slices: ``spectral_ordering`` and the native ``g++``
helpers.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from connectome_gnn_tpu_torch.data.graph import ConnectomeGraph


def reverse_cuthill_mckee(edge_index: np.ndarray, num_nodes: int) -> np.ndarray:
    """RCM permutation: ``perm[new_index] = old_index``.

    Handles disconnected graphs (each component seeded from its
    minimum-degree unvisited node) and isolated nodes.
    """
    # BFS over the symmetrized adjacency (edge direction is irrelevant to
    # bandwidth; the input may store only one direction)
    src = np.concatenate([edge_index[0], edge_index[1]]).astype(np.int64)
    dst = np.concatenate([edge_index[1], edge_index[0]]).astype(np.int64)
    order = np.argsort(dst, kind="stable")
    src_sorted = src[order]
    starts = np.searchsorted(dst[order], np.arange(num_nodes))
    ends = np.searchsorted(dst[order], np.arange(num_nodes), side="right")
    return _rcm_numpy(num_nodes, src_sorted, starts, ends, ends - starts)


def _rcm_numpy(
    num_nodes: int,
    src_sorted: np.ndarray,
    starts: np.ndarray,
    ends: np.ndarray,
    degree: np.ndarray,
) -> np.ndarray:
    """The RCM BFS over a CSR (``src_sorted`` rows ``starts:ends``)."""
    visited = np.zeros(num_nodes, bool)
    result: list[int] = []
    by_degree = np.argsort(degree, kind="stable")

    for seed in by_degree:
        if visited[seed]:
            continue
        visited[seed] = True
        queue = deque([int(seed)])
        while queue:
            node = queue.popleft()
            result.append(node)
            nbrs = np.unique(src_sorted[starts[node] : ends[node]])
            nbrs = nbrs[~visited[nbrs]]
            visited[nbrs] = True
            for nbr in nbrs[np.argsort(degree[nbrs], kind="stable")]:
                queue.append(int(nbr))

    return np.asarray(result[::-1], np.int64)


def apply_ordering(graph: ConnectomeGraph, perm: np.ndarray) -> ConnectomeGraph:
    """Relabel a graph by ``perm`` (``perm[new] = old``)."""
    inverse = np.empty_like(perm)
    inverse[perm] = np.arange(len(perm))
    return ConnectomeGraph(
        node_features=graph.node_features[perm],
        edge_index=inverse[graph.edge_index.astype(np.int64)].astype(np.int32),
        edge_weight=graph.edge_weight,
        label=graph.label,
        subject_id=graph.subject_id,
    )


def bandwidth(edge_index: np.ndarray) -> int:
    """Maximum |sender - receiver| index distance over all edges."""
    if edge_index.shape[1] == 0:
        return 0
    return int(np.abs(edge_index[0].astype(np.int64) - edge_index[1].astype(np.int64)).max())
