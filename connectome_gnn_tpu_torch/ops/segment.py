"""Segment reductions and COO SpMM.

The numerical contract matches ``connectome_gnn_tpu.ops.segment``: means
divide by ``count + 1e-8``, never by a clamped count.

Padding ids: :func:`~connectome_gnn_tpu_torch.data.batch.collate_graphs`
pads senders and receivers with id ``P`` (one past the last node) and
padded nodes with graph id ``B``.  JAX drops out-of-range segment ids and
clamps out-of-range gathers; torch's ``index_add_`` and indexing raise on
them instead (or assert on the device).  So :func:`segment_sum` routes
every id outside ``[0, num_segments)`` to one spare row that it slices off,
and the gathers here clamp their indices into range (the gathered value is
then multiplied by a zero padding weight).
"""

from __future__ import annotations

from typing import Optional

import torch

EPS = 1e-8


def segment_sum(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Sum ``data`` rows into ``num_segments`` buckets; out-of-range ids
    (the padding convention) are dropped."""
    valid = (segment_ids >= 0) & (segment_ids < num_segments)
    ids = torch.where(valid, segment_ids, num_segments)
    out = data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]))
    out.index_add_(0, ids, data)
    return out[:num_segments]


def segment_mean(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Mean of ``data`` rows per segment, with the ``+1e-8`` denominator."""
    totals = segment_sum(data, segment_ids, num_segments)
    ones = data.new_ones((data.shape[0], 1))
    counts = segment_sum(ones, segment_ids, num_segments)
    return totals / (counts + EPS)


def graph_mean_pool(
    node_emb: torch.Tensor, node_graph_ids: torch.Tensor, num_graphs: int
) -> torch.Tensor:
    """Mean-pool node embeddings per graph → ``[num_graphs, F]``; padded
    nodes (graph id ``num_graphs``) drop out of both sum and count."""
    return segment_mean(node_emb, node_graph_ids, num_graphs)


def coo_spmm(
    values: torch.Tensor,
    senders: torch.Tensor,
    receivers: torch.Tensor,
    features: torch.Tensor,
    num_nodes: int,
    *,
    edge_chunk: Optional[int] = None,
) -> torch.Tensor:
    """``out[i] = Σ_{e : receivers[e]=i} values[e] * features[senders[e]]``.

    Padded edges must carry ``values == 0``.  Their sender id ``P`` is
    clamped to a real row for the gather (as JAX clamps it) and their
    receiver id is dropped by :func:`segment_sum`.

    The gather is ``index_select``, not ``features[idx]``: on the CPU the
    backward of advanced indexing accumulates in a thread-dependent order,
    and that of ``index_select`` (an ``index_add_``) does not, so a COO
    training run on the CPU replays bitwise.

    ``edge_chunk`` bounds the memory of a giant edge list: the gathered
    messages take ``E·F`` values at once, so past ``edge_chunk`` edges the
    list is taken in slices of that many, each added into an
    ``[num_nodes + 1, F]`` carry whose last row takes the dropped ids.  The
    float32 sum's order changes with the slicing.
    """
    last = num_nodes - 1
    E = values.shape[0]
    if edge_chunk is None or E <= int(edge_chunk):
        messages = features.index_select(0, senders.clamp(0, last)) * values[:, None]
        return segment_sum(messages, receivers, num_nodes)
    dtype = torch.promote_types(features.dtype, values.dtype)
    out = features.new_zeros((num_nodes + 1, features.shape[1]), dtype=dtype)
    for lo in range(0, E, int(edge_chunk)):
        sl = slice(lo, lo + int(edge_chunk))
        r = receivers[sl]
        ids = torch.where((r >= 0) & (r < num_nodes), r, num_nodes)
        messages = features.index_select(0, senders[sl].clamp(0, last)) * values[sl, None]
        out.index_add_(0, ids, messages)
    return out[:num_nodes]


def sddmm(
    x: torch.Tensor, y: torch.Tensor, senders: torch.Tensor, receivers: torch.Tensor
) -> torch.Tensor:
    """Sampled dense-dense product over an edge list:
    ``out[e] = x[receivers[e]] · y[senders[e]]``, the per-edge dot of node
    embeddings.  Padding ids are clamped to a real row, as JAX clamps them."""
    xr = x.index_select(0, receivers.clamp(0, x.shape[0] - 1))
    ys = y.index_select(0, senders.clamp(0, y.shape[0] - 1))
    return (xr * ys).sum(dim=-1)
