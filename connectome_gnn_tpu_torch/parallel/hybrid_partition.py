"""Sharded hybrid (band + remainder) giant graphs, and the static row
exchange both giant-graph partitions share.

The port of ``connectome_gnn_tpu/parallel/hybrid_partition.py``.  Real
giant connectomes are mostly local with a few long-range shortcuts: the
band bulk of a :class:`~connectome_gnn_tpu_torch.ops.banded.HybridMatrix`
keeps the halo exchange of :mod:`~connectome_gnn_tpu_torch.parallel.
banded_partition`, and the remainder's cross-shard senders ride a static
all-to-all:

* host side (:func:`partition_hybrid`): each remainder edge belongs to
  its receiver's shard; for each ordered shard pair ``(i → j)`` the unique
  sender rows ``j`` borrows from ``i`` are padded into ``send_idx [D, D,
  U]`` (static capacities);
* on the device, one all-to-all ships the borrowed activation rows each
  layer (:func:`exchange_rows`) into a ``[local rows ‖ received rows]``
  table (:func:`remainder_table`); GCN's sender degrees go the other way,
  partial sums all-to-all-ed back and added into their owners
  (:func:`reverse_scatter`).

A cohort stacked for the 2-D mesh needs one static shape, so
:func:`partition_hybrid_cohort` unifies the capacities over its subjects.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from connectome_gnn_tpu_torch.ops.banded import HybridMatrix
from connectome_gnn_tpu_torch.parallel.banded_partition import (
    PartitionedBanded,
    partition_banded,
    partition_banded_from_coo,
    stack_partitioned,
)
from connectome_gnn_tpu_torch.parallel.mesh import Mesh


@dataclasses.dataclass
class PartitionedHybrid:
    """A hybrid giant graph sharded by contiguous row blocks.

    ``banded`` carries the band bulk, features, masks and labels (see
    :class:`PartitionedBanded`).  Remainder edges belong to their
    receiver's shard and address senders through ``rem_src_slot``, an
    index into the per-shard ``[p_local local rows ‖ D·U received rows]``
    table; ``send_idx[i, j, u]`` is the local row (on shard ``i``) of the
    ``u``-th row shard ``j`` borrows from it.  Padding holds ``p_local``
    in ``rem_receivers`` and ``send_idx`` (dropped by the sums, clamped on
    gathers) and weight 0.
    """

    banded: PartitionedBanded
    rem_weights: torch.Tensor     # [D, E_loc] float32, 0 on padding
    rem_receivers: torch.Tensor   # [D, E_loc] int64 local rows, padding p_local
    rem_src_slot: torch.Tensor    # [D, E_loc] int64 into the table
    send_idx: torch.Tensor        # [D, D, U] int64 local rows, padding p_local
    num_shards: int = 1
    bandwidth: int = 0

    # the PartitionedBanded surface, so the models treat both alike
    @property
    def band(self):
        return self.banded.band

    @property
    def node_features(self):
        return self.banded.node_features

    @property
    def node_mask(self):
        return self.banded.node_mask

    @property
    def labels(self):
        return self.banded.labels

    @property
    def label_mask(self):
        return self.banded.label_mask

    @property
    def block(self) -> int:
        return int(self.banded.band.shape[-1])


def _remainder_metadata(s, r, w, D: int, p_local: int):
    """Group the remainder COO by ordered shard pair in one lexsort: edges
    by ``(receiver shard, sender shard, sender row)``, each pair's unique
    borrowed rows the adjacent-dedup of its slice.  Returns the shard and
    local decompositions, the pair grouping ``(order, pair_ids, starts,
    ends)``, the unique rows per pair and the raw ``(max_u, e_loc)``."""
    d_r, r_loc = r // p_local, r % p_local
    d_s, s_loc = s // p_local, s % p_local
    key = d_r * D + d_s
    order = np.lexsort((s_loc, key))
    k_sorted = key[order]
    pair_ids, starts = np.unique(k_sorted, return_index=True)
    ends = np.append(starts[1:], k_sorted.size)
    uniques: dict[tuple[int, int], np.ndarray] = {}
    max_u = 0
    for pid, a0, a1 in zip(pair_ids.tolist(), starts.tolist(), ends.tolist()):
        j, i = divmod(pid, D)  # key = d_r·D + d_s
        if i == j:
            continue
        rows = s_loc[order[a0:a1]]  # ascending by construction
        keep = np.empty(rows.size, bool)
        keep[0] = True
        np.not_equal(rows[1:], rows[:-1], out=keep[1:])
        u = rows[keep]
        uniques[(i, j)] = u
        max_u = max(max_u, u.size)
    e_loc = int(np.bincount(d_r, minlength=D).max()) if d_r.size else 0
    return (d_r, r_loc, d_s, s_loc), (order, pair_ids, starts, ends), uniques, max_u, e_loc


def _round_capacities(max_u: int, e_loc: int, edge_multiple: int, slot_multiple: int,
                      edge_capacity: Optional[int], slot_capacity: Optional[int]):
    """Static paddings from the raw maxima, and explicit capacities
    checked against them."""
    U = max(slot_multiple, -(-max_u // slot_multiple) * slot_multiple)
    if slot_capacity is not None:
        if slot_capacity < max_u:
            raise ValueError(
                f"slot_capacity={slot_capacity} < required {max_u} borrowed rows on some shard pair"
            )
        U = int(slot_capacity)
    E_loc = max(edge_multiple, -(-max(e_loc, 1) // edge_multiple) * edge_multiple)
    if edge_capacity is not None:
        if edge_capacity < e_loc:
            raise ValueError(
                f"edge_capacity={edge_capacity} < required {e_loc} remainder edges on some shard"
            )
        E_loc = int(edge_capacity)
    return E_loc, U


def _real_remainder(h: HybridMatrix):
    """The remainder COO without its padding slots (int64, float32)."""
    s = h.remainder_senders.cpu().numpy().astype(np.int64)
    r = h.remainder_receivers.cpu().numpy().astype(np.int64)
    w = h.remainder_weights.cpu().numpy().astype(np.float32)
    real = r < h.band.num_blocks * h.band.block
    return s[real], r[real], w[real]


def hybrid_remainder_capacities(h: HybridMatrix, num_shards: int, *, edge_multiple: int = 128,
                                slot_multiple: int = 8) -> tuple[int, int]:
    """The ``(edge_capacity, slot_capacity)`` :func:`partition_hybrid`
    would derive for this graph, from the metadata alone."""
    nb_local = -(-h.band.num_blocks // num_shards)
    p_local = nb_local * h.band.block
    s, r, w = _real_remainder(h)
    _, _, _, max_u, e_loc = _remainder_metadata(s, r, w, num_shards, p_local)
    return _round_capacities(max_u, e_loc, edge_multiple, slot_multiple, None, None)


def _partition_remainder(s, r, w, D: int, p_local: int, lo: int, hi: int, edge_multiple: int,
                         slot_multiple: int, edge_capacity, slot_capacity):
    """The receiver-owned remainder arrays and send table of shards
    ``[lo, hi)`` from the real remainder COO (host side)."""
    (d_r, r_loc, d_s, s_loc), (order, pair_ids, starts, ends), uniques, max_u, e_loc = \
        _remainder_metadata(s, r, w, D, p_local)
    E_loc, U = _round_capacities(max_u, e_loc, edge_multiple, slot_multiple, edge_capacity,
                                 slot_capacity)

    send_idx = np.full((hi - lo, D, U), p_local, np.int64)
    for (i, j), rows in uniques.items():
        if lo <= i < hi:
            send_idx[i - lo, j, : rows.size] = rows

    # table slots for every edge, one vectorized pass over the pair groups
    slot = np.empty(s.size, np.int64)
    local = d_s == d_r
    slot[local] = s_loc[local]
    for pid, a0, a1 in zip(pair_ids.tolist(), starts.tolist(), ends.tolist()):
        j, i = divmod(pid, D)
        if i == j:
            continue
        sel = order[a0:a1]
        slot[sel] = p_local + i * U + np.searchsorted(uniques[(i, j)], s_loc[sel])

    # receiver-sorted per destination shard (a stable lexsort)
    order_r = np.lexsort((r_loc, d_r))
    bounds = np.searchsorted(d_r[order_r], np.arange(D + 1))
    rem_w = np.zeros((hi - lo, E_loc), np.float32)
    rem_r = np.full((hi - lo, E_loc), p_local, np.int64)
    rem_slot = np.zeros((hi - lo, E_loc), np.int64)
    for j in range(lo, hi):
        sel = order_r[bounds[j] : bounds[j + 1]]
        k = sel.size
        rem_w[j - lo, :k] = w[sel]
        rem_r[j - lo, :k] = r_loc[sel]
        rem_slot[j - lo, :k] = slot[sel]
    return rem_w, rem_r, rem_slot, send_idx


def _hybrid(pb: PartitionedBanded, rem) -> PartitionedHybrid:
    rem_w, rem_r, rem_slot, send_idx = (torch.from_numpy(a) for a in rem)
    return PartitionedHybrid(banded=pb, rem_weights=rem_w, rem_receivers=rem_r,
                             rem_src_slot=rem_slot, send_idx=send_idx,
                             num_shards=pb.num_shards, bandwidth=pb.bandwidth)


def partition_hybrid(
    h: HybridMatrix,
    x: np.ndarray,
    num_shards: int,
    *,
    node_mask: Optional[np.ndarray] = None,
    labels: Optional[np.ndarray] = None,
    edge_multiple: int = 128,
    slot_multiple: int = 8,
    edge_capacity: Optional[int] = None,
    slot_capacity: Optional[int] = None,
    shard_range: Optional[tuple[int, int]] = None,
) -> PartitionedHybrid:
    """Shard a hybrid matrix and its features by row blocks on the host
    (``hybrid_partition.py:244``), bitwise the JAX package's.

    ``edge_capacity`` / ``slot_capacity`` pin the remainder paddings (a
    stacked cohort needs one shape; too small raises).  ``shard_range``
    materializes only shards ``[lo, hi)``; the send tables and paddings
    stay globally derived.
    """
    pb = partition_banded(h.band, x, num_shards, node_mask=node_mask, labels=labels,
                          shard_range=shard_range)
    lo, hi = shard_range if shard_range is not None else (0, num_shards)
    p_local = pb.blocks_per_shard * pb.block
    s, r, w = _real_remainder(h)
    return _hybrid(pb, _partition_remainder(s, r, w, num_shards, p_local, lo, hi, edge_multiple,
                                            slot_multiple, edge_capacity, slot_capacity))


def partition_hybrid_from_coo(
    senders: np.ndarray,
    receivers: np.ndarray,
    weights: np.ndarray,
    x: np.ndarray,
    num_nodes: int,
    num_shards: int,
    *,
    block: int = 256,
    bandwidth: int = 4,
    node_mask: Optional[np.ndarray] = None,
    labels: Optional[np.ndarray] = None,
    edge_multiple: int = 128,
    slot_multiple: int = 8,
    edge_capacity: Optional[int] = None,
    slot_capacity: Optional[int] = None,
    shard_range: Optional[tuple[int, int]] = None,
) -> PartitionedHybrid:
    """Streamed hybrid ingest (``hybrid_partition.py:296``): a COO edge
    list straight into sharded band slabs and remainder tables, never the
    whole :class:`HybridMatrix`.  Edges split by block distance as in
    ``to_hybrid``; the band slabs are :func:`partition_banded_from_coo`'s."""
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    weights = np.asarray(weights, np.float32)
    in_band = np.abs(senders // block - receivers // block) <= bandwidth
    pb = partition_banded_from_coo(
        senders[in_band], receivers[in_band], weights[in_band], x, num_nodes, num_shards,
        block=block, bandwidth=bandwidth, node_mask=node_mask, labels=labels,
        shard_range=shard_range,
    )
    lo, hi = shard_range if shard_range is not None else (0, num_shards)
    p_local = pb.blocks_per_shard * pb.block
    return _hybrid(pb, _partition_remainder(
        senders[~in_band], receivers[~in_band], weights[~in_band], num_shards, p_local, lo, hi,
        edge_multiple, slot_multiple, edge_capacity, slot_capacity))


def partition_hybrid_cohort(hybrids, features, num_shards: int, *, labels=None,
                            **kwargs) -> PartitionedHybrid:
    """A cohort of hybrid subjects partitioned with unified capacities and
    stacked for the ``("data", "edge")`` mesh (``hybrid_partition.py:357``):
    the worst capacities come from :func:`hybrid_remainder_capacities`, so
    each subject is partitioned once.  Tensors ``[Dd·De, ...]``."""
    labels = labels if labels is not None else [None] * len(hybrids)
    probe_kw = {k: kwargs[k] for k in ("edge_multiple", "slot_multiple") if k in kwargs}
    caps = [hybrid_remainder_capacities(h, num_shards, **probe_kw) for h in hybrids]
    kwargs.setdefault("edge_capacity", max((c[0] for c in caps), default=128))
    kwargs.setdefault("slot_capacity", max((c[1] for c in caps), default=8))
    return stack_partitioned([
        partition_hybrid(h, x, num_shards, labels=lab, **kwargs)
        for h, x, lab in zip(hybrids, features, labels)
    ])


# ---------------------------------------------------------------------------
# Stacked gathers and sums, and the row exchange (device side)
# ---------------------------------------------------------------------------


def stacked_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[s, idx[s]]`` for every local shard ``s``: ``table [S, T,
    ...]``, ``idx [S, E]`` in ``[0, T)`` → ``[S, E, ...]`` (one
    ``index_select``, whose backward sums in a fixed order on the CPU)."""
    S, T = table.shape[:2]
    offsets = torch.arange(S, device=idx.device)[:, None] * T
    rows = table.reshape(S * T, *table.shape[2:]).index_select(0, (idx + offsets).reshape(-1))
    return rows.view(*idx.shape, *table.shape[2:])


def stacked_segment_sum(data: torch.Tensor, idx: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``data [S, E, ...]`` summed into ``[S, num_segments, ...]`` by
    ``idx [S, E]`` per shard; ids outside ``[0, num_segments)`` (the
    padding) are dropped."""
    S = idx.shape[0]
    valid = (idx >= 0) & (idx < num_segments)
    ids = torch.where(valid, idx, num_segments)
    ids = ids + torch.arange(S, device=idx.device)[:, None] * (num_segments + 1)
    out = data.new_zeros((S * (num_segments + 1),) + tuple(data.shape[2:]))
    out.index_add_(0, ids.reshape(-1), data.reshape(-1, *data.shape[2:]))
    return out.view(S, num_segments + 1, *data.shape[2:])[:, :num_segments]


def exchange_rows(values: torch.Tensor, send_idx: torch.Tensor, mesh: Mesh,
                  axis_name: str) -> torch.Tensor:
    """Ship borrowed rows to their borrowers (``hybrid_partition.py:405``).

    ``values [S, p_local, ...]`` are each shard's rows; ``send_idx [S, D,
    U]`` names the rows each shard of the group needs (padding
    ``p_local``).  Returns ``recv [S, D, U, ...]``: block ``i`` holds the
    rows this shard borrows from shard ``i``, aligned with table slots
    ``p_local + i·U + u``.
    """
    safe = torch.clamp(send_idx, max=values.shape[1] - 1)
    S, D, U = send_idx.shape
    rows = stacked_gather(values, safe.reshape(S, D * U)).view(S, D, U, *values.shape[2:])
    return mesh.all_to_all(rows, axis_name)


def remainder_table(values: torch.Tensor, send_idx: torch.Tensor, mesh: Mesh,
                    axis_name: str) -> torch.Tensor:
    """``[p_local local rows ‖ D·U borrowed rows]`` per shard, the table
    the slot indices address; one all-to-all."""
    recv = exchange_rows(values, send_idx, mesh, axis_name)
    return torch.cat([values, recv.reshape(values.shape[0], -1, *values.shape[2:])], dim=1)


def remainder_aggregate(values: torch.Tensor, edge_weights: torch.Tensor,
                        shard: PartitionedHybrid, mesh: Mesh, axis_name: str) -> torch.Tensor:
    """The remainder edges' weighted sum into local receiver rows, ``[S,
    p_local, H]``: the per-layer remainder step of both sharded model
    families."""
    table = remainder_table(values, shard.send_idx, mesh, axis_name)
    msgs = stacked_gather(table, shard.rem_src_slot) * edge_weights[..., None]
    return stacked_segment_sum(msgs, shard.rem_receivers, values.shape[1])


def reverse_scatter(partials: torch.Tensor, send_idx: torch.Tensor, p_local: int, mesh: Mesh,
                    axis_name: str) -> torch.Tensor:
    """Return borrowed-row partial sums to their owners
    (``hybrid_partition.py:455``): ``partials [S, D, U, ...]`` (block ``i``
    the sums this shard made for rows borrowed from shard ``i``) go back
    by the all-to-all, and block ``j`` of what arrives is added into our
    rows ``send_idx[j]``; ``[S, p_local, ...]``."""
    back = mesh.all_to_all(partials, axis_name)
    S = send_idx.shape[0]
    return stacked_segment_sum(back.reshape(S, -1, *partials.shape[3:]),
                               send_idx.reshape(S, -1), p_local)
