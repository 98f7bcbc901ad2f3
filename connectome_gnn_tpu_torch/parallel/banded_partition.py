"""Halo-exchange parallelism for banded giant graphs.

The port of ``connectome_gnn_tpu/parallel/banded_partition.py``.  The block
band is sharded by contiguous row blocks.  Every edge lies within ``W``
blocks of the diagonal, so a shard needs only the ``W`` boundary blocks of
each neighbor: a layer's exchange is two shifts of ``W · block · H``
activations along a chain of shards (:func:`halo_exchange`; the end
shards receive zeros, where the band is zero anyway), not an all-gather of
the feature matrix.  Sender degrees are exact: partial block sums that
fall past a shard's rows go back to their owners the same way
(:func:`halo_reduce_degrees`); the normalization and sync-BatchNorm are
the single-device model's.

:func:`partition_banded` (or, never building the whole band,
:func:`partition_banded_from_coo`) shards a band and its features on the
host; :class:`ShardedBandedGCN` and :class:`ShardedBandedSAGE` run it with
the parameters of :class:`~connectome_gnn_tpu_torch.models.node_gcn.
BandedNodeGCN` / ``BandedNodeSAGE``.  A cohort of such graphs trains on a
``("data", "edge")`` mesh (:func:`stack_partitioned`,
:func:`make_banded_train_step_2d`), whose single-device oracle is the
model over :func:`~connectome_gnn_tpu_torch.ops.banded.banded_block_diag`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from connectome_gnn_tpu_torch.data.batch import round_up
from connectome_gnn_tpu_torch.models.layers import EPS
from connectome_gnn_tpu_torch.models.node_gcn import BandedNodeGCN
from connectome_gnn_tpu_torch.models.node_sage import BandedNodeSAGE
from connectome_gnn_tpu_torch.nn.layers import Dropout
from connectome_gnn_tpu_torch.ops.banded import BandedMatrix, band_windows
from connectome_gnn_tpu_torch.parallel.mesh import Mesh
from connectome_gnn_tpu_torch.parallel.shard_forward import (
    ShardForwardMixin,
    make_node_train_step,
)


@dataclasses.dataclass
class PartitionedBanded:
    """A banded giant graph sharded by contiguous row blocks; tensors carry
    the leading shard axis.

    Attributes
    ----------
    band : float32 [D, NB_local, 2W+1, block, block]
    node_features : float32 [D, NB_local·block, F]
    node_mask : bool [D, NB_local·block]
    labels : int64 [D, NB_local·block]
    label_mask : bool [D, NB_local·block]
    num_shards / bandwidth : int
    """

    band: torch.Tensor
    node_features: torch.Tensor
    node_mask: torch.Tensor
    labels: torch.Tensor
    label_mask: torch.Tensor
    num_shards: int = 1
    bandwidth: int = 0

    @property
    def block(self) -> int:
        return int(self.band.shape[3])

    @property
    def blocks_per_shard(self) -> int:
        return int(self.band.shape[1])


def _shard_geometry(nb: int, W: int, num_shards: int, shard_range):
    """Validate and resolve ``(nb_local, lo, hi)`` of a row-block shard."""
    nb_local = -(-nb // num_shards)
    if W > nb_local:
        raise ValueError(
            f"bandwidth {W} blocks exceeds blocks-per-shard {nb_local}; "
            "use fewer shards or a narrower band"
        )
    lo, hi = shard_range if shard_range is not None else (0, num_shards)
    if not 0 <= lo < hi <= num_shards:
        raise ValueError(f"bad shard_range {(lo, hi)} for D={num_shards}")
    return nb_local, lo, hi


def _assemble_partition(band_p: torch.Tensor, x, node_mask, labels, num_nodes: int,
                        num_shards: int, W: int, nb_local: int, lo: int, hi: int):
    """Pack the node arrays of rows ``[lo·nb_local·block, hi·nb_local·block)``
    of the padded node space (on the host, then onto the band's device)
    and build the partition."""
    d_here = hi - lo
    block = band_p.shape[2]
    n0, n1 = lo * nb_local * block, hi * nb_local * block

    def pad_nodes(arr, fill, dtype):
        out = np.full((n1 - n0,) + arr.shape[1:], fill, dtype)
        if n0 < arr.shape[0]:
            out[: min(n1, arr.shape[0]) - n0] = arr[n0 : min(n1, arr.shape[0])]
        return out

    x = np.asarray(x, np.float32)[:num_nodes]
    mask = (np.asarray(node_mask, bool)[:num_nodes] if node_mask is not None
            else np.ones(num_nodes, bool))
    lab = (np.asarray(labels, np.int64)[:num_nodes] if labels is not None
           else np.zeros(num_nodes, np.int64))
    mask_p = pad_nodes(mask, False, bool)
    p = nb_local * block

    def t(a):
        return torch.from_numpy(a).to(band_p.device)

    return PartitionedBanded(
        band=band_p.view(d_here, nb_local, band_p.shape[1], block, block),
        node_features=t(pad_nodes(x, 0.0, np.float32).reshape(d_here, p, -1)),
        node_mask=t(mask_p.reshape(d_here, p)),
        labels=t(pad_nodes(lab, 0, np.int64).reshape(d_here, p)),
        label_mask=t((mask_p if labels is not None else np.zeros(n1 - n0, bool))
                     .reshape(d_here, p)),
        num_shards=num_shards,
        bandwidth=W,
    )


def partition_banded(
    a: BandedMatrix,
    x: np.ndarray,
    num_shards: int,
    *,
    node_mask: Optional[np.ndarray] = None,
    labels: Optional[np.ndarray] = None,
    shard_range: Optional[tuple[int, int]] = None,
) -> PartitionedBanded:
    """Shard a banded matrix and its node features by row blocks on the host
    (``banded_partition.py:143``), bitwise the JAX package's.

    The block count is padded to a multiple of ``num_shards`` with zero
    blocks; ``W <= blocks_per_shard`` is required (a halo reaches only the
    next shard).  ``shard_range=(lo, hi)`` packs only shards ``[lo, hi)``,
    a process's part, allocating only its rows.  The band stays on its
    device; where no zero block is added the partition's band is a view of
    ``a``'s (no copy of a band of gigabytes).
    """
    band = a.band.to(torch.float32)
    nb, dcount, block, _ = band.shape
    W = a.bandwidth
    nb_local, lo, hi = _shard_geometry(nb, W, num_shards, shard_range)
    b0, b1 = lo * nb_local, hi * nb_local
    if b1 <= nb:
        band_p = band[b0:b1]
    else:
        band_p = band.new_zeros((b1 - b0, dcount, block, block))
        if b0 < nb:
            band_p[: nb - b0] = band[b0:nb]
    return _assemble_partition(band_p, x, node_mask, labels, a.num_nodes, num_shards, W,
                               nb_local, lo, hi)


def partition_banded_from_coo(
    senders: np.ndarray,
    receivers: np.ndarray,
    weights: np.ndarray,
    x: np.ndarray,
    num_nodes: int,
    num_shards: int,
    *,
    block: int = 256,
    bandwidth: Optional[int] = None,
    node_mask: Optional[np.ndarray] = None,
    labels: Optional[np.ndarray] = None,
    shard_range: Optional[tuple[int, int]] = None,
) -> PartitionedBanded:
    """Streamed ingest (``banded_partition.py:184``): a COO edge list
    straight into the shard range's band slab, never the whole band;
    bitwise ``partition_banded(to_banded(...))`` (the native helper and
    ``np.add.at`` visit the edges in the same order).  ``bandwidth``
    defaults to the smallest band holding every edge."""
    from connectome_gnn_tpu_torch import native

    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    weights = np.asarray(weights, np.float32)
    nb = round_up(num_nodes, block) // block
    rb = receivers // block
    d = senders // block - rb
    if bandwidth is None:
        bandwidth = int(np.abs(d).max()) if d.size else 0
    elif d.size and np.abs(d).max() > bandwidth:
        raise ValueError(
            f"edge outside band: |block distance| {int(np.abs(d).max())} > "
            f"bandwidth {bandwidth}; reorder the graph (e.g. RCM) first"
        )
    W = int(bandwidth)
    nb_local, lo, hi = _shard_geometry(nb, W, num_shards, shard_range)
    b0, rows = lo * nb_local, (hi - lo) * nb_local
    band_p = np.zeros((rows, 2 * W + 1, block, block), np.float32)
    if native.AVAILABLE:
        native.band_pack_range(senders, receivers, weights, band_p, W, b0)
    else:
        sel = (rb >= b0) & (rb < b0 + rows)
        np.add.at(band_p, (rb[sel] - b0, d[sel] + W, receivers[sel] % block,
                           senders[sel] % block), weights[sel])
    return _assemble_partition(torch.from_numpy(band_p), x, node_mask, labels, num_nodes,
                               num_shards, W, nb_local, lo, hi)


def stack_partitioned(parts):
    """Stack per-subject partitions (each ``[De, ...]``, one shape) for the
    ``("data", "edge")`` mesh: tensors ``[Dd·De, ...]``, subject-major, the
    mesh's shard order (``banded_partition.py:557`` stacks ``[Dd, De,
    ...]``)."""
    first = parts[0]
    out = {}
    for f in dataclasses.fields(first):
        values = [getattr(p, f.name) for p in parts]
        if isinstance(values[0], torch.Tensor):
            out[f.name] = torch.cat(values)
        elif dataclasses.is_dataclass(values[0]):
            out[f.name] = stack_partitioned(values)
        elif any(v != values[0] for v in values):
            raise ValueError(f"subjects differ in {f.name}: {values}")
        else:
            out[f.name] = values[0]
    return type(first)(**out)


def halo_exchange(blocks: torch.Tensor, W: int, mesh: Mesh, axis_name: str) -> torch.Tensor:
    """``blocks [S, NBl, block, F]`` extended by ``W`` halo blocks a side
    from the neighbors along ``axis_name``; the chain's end shards get
    zeros.  ``[S, NBl + 2W, block, F]``."""
    if W == 0:
        return blocks
    from_left = mesh.shift(blocks[:, -W:], axis_name, 1)
    from_right = mesh.shift(blocks[:, :W], axis_name, -1)
    return torch.cat([from_left, blocks, from_right], dim=1)


def halo_reduce_degrees(deg_ext: torch.Tensor, nb_local: int, W: int, mesh: Mesh,
                        axis_name: str) -> torch.Tensor:
    """Fold the extended range's partial degree sums ``[S, NBl + 2W,
    block]`` back to their owners: a shard's head overflow belongs to its
    left neighbor's tail, and its tail overflow to its right neighbor's
    head."""
    own = deg_ext[:, W : W + nb_local]
    if W == 0:
        return own
    from_right = mesh.shift(deg_ext[:, :W], axis_name, -1)
    from_left = mesh.shift(deg_ext[:, W + nb_local :], axis_name, 1)
    own = own.clone()
    own[:, -W:] += from_right
    own[:, :W] += from_left
    return own


def _windows(t_ext: torch.Tensor, nb_local: int, dcount: int) -> torch.Tensor:
    """``t_ext [S, NBl + 2W, ...]`` read at row block ``rb + d``:
    ``[S, NBl, 2W+1, ...]``."""
    idx = (torch.arange(nb_local, device=t_ext.device)[:, None]
           + torch.arange(dcount, device=t_ext.device)[None, :])
    return t_ext[:, idx]


def _use_shard_dropout(model) -> None:
    """Sharded models draw dropout per shard (:class:`Dropout`'s
    ``shard_generators``), not from torch's global generator."""
    model.dropout = Dropout(model.dropout.p)


class ShardedBandedGCN(ShardForwardMixin, BandedNodeGCN):
    """Halo-exchange sharded :class:`BandedNodeGCN`
    (``banded_partition.py:302``): the same parameters, the forward over a
    :class:`PartitionedBanded` or a sharded hybrid
    (:class:`~connectome_gnn_tpu_torch.parallel.hybrid_partition.
    PartitionedHybrid`)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        _use_shard_dropout(self)

    def apply_shard(self, shard, mesh: Mesh, *, axis_name: str) -> torch.Tensor:
        """Per-node logits ``[S, P, C]``; ``axis_name`` is the axis the row
        blocks are sharded over (the halo's), and BatchNorm statistics span
        every shard of the mesh."""
        from connectome_gnn_tpu_torch.parallel import hybrid_partition as hp

        band = shard.band
        S, nb_local, dcount, block, _ = band.shape
        W = shard.bandwidth
        p_local = nb_local * block
        is_hybrid = isinstance(shard, hp.PartitionedHybrid)

        # exact sender degrees, halo-reduced to their owners
        col_sums = band.sum(dim=3)  # [S, NBl, 2W+1, block]
        deg_ext = band.new_zeros((S, nb_local + 2 * W, block))
        for d in reversed(range(dcount)):  # the JAX segment sum's order
            deg_ext[:, d : d + nb_local] += col_sums[:, :, d]
        deg = halo_reduce_degrees(deg_ext, nb_local, W, mesh, axis_name).reshape(S, p_local)
        if is_hybrid:
            # remainder sender degrees: local slots add in place, borrowed
            # slots are partial sums returned to their owners
            n_slots = p_local + shard.send_idx[0].numel()
            contrib = hp.stacked_segment_sum(shard.rem_weights, shard.rem_src_slot, n_slots)
            deg = deg + contrib[:, :p_local] + hp.reverse_scatter(
                contrib[:, p_local:].reshape(shard.send_idx.shape), shard.send_idx, p_local,
                mesh, axis_name)
        dinv = torch.rsqrt(deg + 1.0 + EPS)  # [S, p_local]
        self_norm = (dinv * dinv)[..., None]
        if is_hybrid:
            dinv_table = hp.remainder_table(dinv, shard.send_idx, mesh, axis_name)
            safe_r = torch.clamp(shard.rem_receivers, max=p_local - 1)
            rem_norm = (hp.stacked_gather(dinv, safe_r) * shard.rem_weights
                        * hp.stacked_gather(dinv_table, shard.rem_src_slot))
        # the senders' dinv needs the halo too
        dinv_ext = halo_exchange(dinv.reshape(S, nb_local, block, 1), W, mesh, axis_name)[..., 0]
        band_norm = dinv.reshape(S, nb_local, 1, block, 1) * band
        band_norm.mul_(_windows(dinv_ext, nb_local, dcount)[:, :, :, None, :])

        mask = shard.node_mask.reshape(-1)
        h = shard.node_features
        for conv, norm in zip(self.convs, self.batch_norms):
            hw = conv.linear(h)
            H = hw.shape[-1]
            hw_ext = halo_exchange(hw.view(S, nb_local, block, H), W, mesh, axis_name)
            agg = band_windows(band_norm, hw_ext).view(S, p_local, H)
            if is_hybrid:
                agg = agg + hp.remainder_aggregate(hw, rem_norm, shard, mesh, axis_name)
            h = agg + self_norm * hw + conv.bias
            h = norm(h.reshape(S * p_local, H), mask)
            h = self.dropout(torch.relu(h)).view(S, p_local, H)
        return self.head(h)


class ShardedBandedSAGE(ShardForwardMixin, BandedNodeSAGE):
    """Halo-exchange sharded :class:`BandedNodeSAGE`
    (``banded_partition.py:428``): the mean's normalizer is the receivers'
    weight sum, all local, so the only exchange is the activations' halo
    (and, for a hybrid, the remainder's borrowed rows)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        _use_shard_dropout(self)

    def apply_shard(self, shard, mesh: Mesh, *, axis_name: str) -> torch.Tensor:
        from connectome_gnn_tpu_torch.parallel import hybrid_partition as hp

        band = shard.band
        S, nb_local, dcount, block, _ = band.shape
        W = shard.bandwidth
        p_local = nb_local * block
        is_hybrid = isinstance(shard, hp.PartitionedHybrid)

        w_sum = band.sum(dim=(2, 4)).reshape(S, p_local)
        if is_hybrid:
            w_sum = w_sum + hp.stacked_segment_sum(shard.rem_weights, shard.rem_receivers,
                                                   p_local)
        w_sum = w_sum[..., None]
        mask = shard.node_mask.reshape(-1)
        h = shard.node_features
        for conv, norm in zip(self.convs, self.batch_norms):
            F = h.shape[-1]
            h_ext = halo_exchange(h.reshape(S, nb_local, block, F), W, mesh, axis_name)
            msg = band_windows(band, h_ext).view(S, p_local, F)
            if is_hybrid:
                msg = msg + hp.remainder_aggregate(h, shard.rem_weights, shard, mesh, axis_name)
            h = torch.relu(conv.linear(torch.cat([h, msg / (w_sum + EPS)], dim=-1)))
            H = h.shape[-1]
            # the reference SAGE asymmetry: no ReLU after the BatchNorm
            h = self.dropout(norm(h.reshape(S * p_local, H), mask)).view(S, p_local, H)
        return self.head(h)


def _require_axes(mesh: Mesh, axes: tuple, what: str) -> None:
    if mesh.axis_names != axes:
        raise ValueError(f"{what} runs on a mesh with axes {axes}, not {mesh.axis_names}")


def make_sharded_banded_train_step(model, optimizer, mesh: Mesh, axis_name: str = "edge",
                                   seed: int = 0):
    """A node-classification train step over a sharded banded (or hybrid)
    graph on a 1-D mesh (``banded_partition.py:502``): ``step(pbanded) ->
    (loss, n)``, the masked mean cross-entropy over every shard's labelled
    nodes; exact against one device at dropout 0 (dropout draws per shard
    from generators seeded from ``seed``)."""
    _require_axes(mesh, (axis_name,), "make_sharded_banded_train_step")
    return make_node_train_step(model, optimizer, mesh, axis_name, seed)


def make_banded_train_step_2d(model, optimizer, mesh: Mesh, data_axis: str = "data",
                              edge_axis: str = "edge", seed: int = 0):
    """Data × edge parallelism over a 2-D mesh (``banded_partition.py:568``):
    a cohort of giant graphs trains jointly, subjects over ``data_axis``,
    each subject's row blocks over ``edge_axis`` with the halo of the 1-D
    step.  BatchNorm statistics and the loss's normalization span both
    axes, so at dropout 0 the step is single-device training on the
    cohort's :func:`~connectome_gnn_tpu_torch.ops.banded.banded_block_diag`.
    ``step(stacked) -> (loss, n)`` with ``stacked`` from
    :func:`stack_partitioned`."""
    _require_axes(mesh, (data_axis, edge_axis), "make_banded_train_step_2d")
    return make_node_train_step(model, optimizer, mesh, edge_axis, seed)
