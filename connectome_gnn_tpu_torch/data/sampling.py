"""Host-side neighbor sampling for giant-graph training.

The port of ``connectome_gnn_tpu/data/sampling.py``: GraphSAGE-style k-hop
fanout sampling (Hamilton et al., 2017).  Starting from seed nodes it
samples up to ``fanout[h]`` incoming neighbors per node at hop ``h`` and
induces the subgraph over every reached node.  It runs in numpy and in the
native helpers (``native.sample_subgraph``, ``sampler_sample_collate``, a
byte-identical copy of the JAX package's C++), so for the same numpy
generator or the same splitmix64 seed the samples are bitwise the JAX
package's.  The result is a relabelled :class:`ConnectomeGraph` plus the
original node ids, which :mod:`connectome_gnn_tpu_torch.data.sampled`
packs into static-shape batches.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from connectome_gnn_tpu_torch import native
from connectome_gnn_tpu_torch.data.graph import ConnectomeGraph


def sample_subgraph(
    graph: ConnectomeGraph,
    seed_nodes: Sequence[int],
    fanout: Sequence[int],
    rng: Optional[np.random.Generator] = None,
) -> tuple[ConnectomeGraph, np.ndarray]:
    """Sample a k-hop neighborhood subgraph with numpy's generator.

    Hop expansion follows edges *into* the frontier (message flow); a node
    with more than ``fanout[h]`` in-edges keeps ``rng.choice`` of them,
    without replacement.  Returns ``(subgraph, node_ids)``: the relabelled
    subgraph over the reached nodes, holding every kept edge, and the
    original id of each subgraph node, seeds first and in order.
    """
    if rng is None:
        rng = np.random.default_rng()
    src, dst = graph.edge_index
    order, starts, ends = _in_edge_index(graph)
    seeds = _dedup_seeds(seed_nodes, graph.num_nodes)
    visited = dict((int(s), i) for i, s in enumerate(seeds))
    frontier = list(seeds)
    kept_edges: list[int] = []

    for hop_fanout in fanout:
        next_frontier: list[int] = []
        for node in frontier:
            lo, hi = int(starts[node]), int(ends[node])
            incident = order[lo:hi]
            if len(incident) > hop_fanout:
                incident = rng.choice(incident, size=hop_fanout, replace=False)
            for e in incident:
                kept_edges.append(int(e))
                nbr = int(src[e])
                if nbr not in visited:
                    visited[nbr] = len(visited)
                    next_frontier.append(nbr)
        frontier = next_frontier
        if not frontier:
            break

    node_ids = np.fromiter(visited.keys(), np.int64, len(visited))
    kept = np.asarray(sorted(set(kept_edges)), np.int64)
    return _induced(graph, node_ids, kept), node_ids


def _induced(graph: ConnectomeGraph, node_ids: np.ndarray, kept: np.ndarray) -> ConnectomeGraph:
    """The subgraph over ``node_ids`` (relabelled in their order) holding
    the edges ``kept``."""
    src, dst = graph.edge_index
    relabel = np.full(graph.num_nodes, -1, np.int64)
    relabel[node_ids] = np.arange(len(node_ids))
    return ConnectomeGraph(
        node_features=graph.node_features[node_ids],
        edge_index=np.stack([relabel[src[kept]], relabel[dst[kept]]]).astype(np.int32),
        edge_weight=graph.edge_weight[kept],
        label=graph.label,
        subject_id=f"{graph.subject_id}-sub{len(node_ids)}",
    )


def _in_edge_index(graph: ConnectomeGraph):
    """Receiver-grouped edge index: ``order[starts[v]:ends[v]]`` are the
    edge ids whose receiver is ``v``.  Shared by the numpy and native
    samplers, so their traversals cannot drift apart."""
    dst = graph.edge_index[1]
    order = np.argsort(dst, kind="stable").astype(np.int64)
    dst_sorted = dst[order]
    starts = np.searchsorted(dst_sorted, np.arange(graph.num_nodes))
    ends = np.searchsorted(dst_sorted, np.arange(graph.num_nodes), side="right")
    return order, starts, ends


def _dedup_seeds(seed_nodes, num_nodes: int) -> np.ndarray:
    """Order-preserving dedup and range check (numpy's fancy indexing
    would wrap a negative seed silently)."""
    seeds = np.asarray(list(dict.fromkeys(int(s) for s in seed_nodes)), np.int64)
    if seeds.size and (seeds.min() < 0 or seeds.max() >= num_nodes):
        raise ValueError("seed node out of range")
    return seeds


class NeighborSampler:
    """Reusable k-hop fanout sampler over one giant graph.

    Builds the receiver-grouped edge index once (re-sorting the edge list
    is most of a one-shot sample at giant scale); each :meth:`sample` then
    runs only the native traversal.  Same traversal and return contract as
    :func:`sample_subgraph`, but the draws come from a splitmix64 stream,
    not numpy's ``Generator.choice``; deterministic for a given ``seed``.
    Where the native library is unavailable it takes
    :func:`sample_subgraph` with ``np.random.default_rng(seed)``, as the
    JAX package does.
    """

    def __init__(self, graph: ConnectomeGraph):
        self.graph = graph
        self._src = graph.edge_index[0].astype(np.int64)
        self._order, self._starts, self._ends = _in_edge_index(graph)
        self._weights = np.ascontiguousarray(graph.edge_weight, np.float32)
        self._handle = None  # the fused sampler's scratch, made at first use

    def __del__(self):
        try:
            if self._handle:
                native.sampler_free(self._handle)
        except Exception:
            pass

    def sample(
        self, seed_nodes: Sequence[int], fanout: Sequence[int], seed: int = 0
    ) -> tuple[ConnectomeGraph, np.ndarray]:
        graph = self.graph
        seeds = _dedup_seeds(seed_nodes, graph.num_nodes)
        if not native.AVAILABLE:
            return sample_subgraph(graph, seeds, fanout, np.random.default_rng(seed))
        node_ids, kept = native.sample_subgraph(
            self._order, self._starts, self._ends, self._src,
            graph.num_nodes, graph.num_edges,
            seeds, np.asarray(fanout, np.int64), seed,
        )
        return _induced(graph, node_ids, kept), node_ids

    def sample_collate_into(
        self,
        seed_nodes: np.ndarray,
        fanout: Sequence[int],
        seed: int,
        *,
        node_budget: int,
        edge_budget: int,
        out_senders: np.ndarray,
        out_receivers: np.ndarray,
        out_weights: np.ndarray,
        out_node_ids: np.ndarray,
    ) -> tuple[int, int]:
        """Fused sample and padded collate, written in place; returns
        ``(n_nodes, n_edges)``.

        One native traversal writes the locally relabelled,
        receiver-sorted, budget-padded ``senders`` / ``receivers`` /
        ``weights`` / ``node_ids`` (int32, int32, float32, int32) that a
        :class:`~connectome_gnn_tpu_torch.data.sampled.SampledNodeBatch`
        holds.  Same splitmix64 stream as :meth:`sample`, so the same
        subgraph for the same ``seed``; only the edge order within a
        receiver differs from :func:`~connectome_gnn_tpu_torch.data.
        sampled.collate_sampled`'s (draw order, not edge id).  Needs the
        native library; not thread-safe per sampler (its scratch is reused).
        """
        if not native.AVAILABLE:
            raise RuntimeError("native library unavailable")
        if self._handle is None:
            self._handle = native.sampler_new(self.graph.num_nodes)
        seeds = np.ascontiguousarray(seed_nodes, np.int64)
        return native.sampler_sample_collate(
            self._handle,
            self._order, self._starts, self._ends, self._src,
            self._weights,
            seeds, np.asarray(fanout, np.int64), seed,
            node_budget, edge_budget,
            out_senders, out_receivers, out_weights, out_node_ids,
        )


def sample_subgraph_fast(
    graph: ConnectomeGraph,
    seed_nodes: Sequence[int],
    fanout: Sequence[int],
    seed: int = 0,
) -> tuple[ConnectomeGraph, np.ndarray]:
    """One-shot native k-hop sampling (:class:`NeighborSampler` amortizes
    the index build across repeated samples)."""
    return NeighborSampler(graph).sample(seed_nodes, fanout, seed)
