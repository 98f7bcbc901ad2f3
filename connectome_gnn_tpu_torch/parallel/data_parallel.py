"""Exact data parallelism for batched graph classification.

The port of ``connectome_gnn_tpu/parallel/data_parallel.py``.  A batch is
sharded over the mesh's ``"data"`` axis as a *stacked* batch: the loader's
``num_shards`` collates one batch per shard and :func:`stack_batches`
stacks them leaf-wise into ``[D_local, ...]`` tensors.

Graphs are independent, so a rank runs its shards as one batch
(:func:`merge_shards`, no loop over shards), and so do sampled node
batches (:func:`merge_sampled`: every shard's seeds first, then each hop's
draws of every shard, which keeps the blocked layers' contiguous slices);
what crosses shards is only
BatchNorm's moments (sync-BatchNorm, summed over the mesh inside the
forward) and the loss's sum and count.  The loss is the globally masked
mean (:func:`~connectome_gnn_tpu_torch.parallel.shard_forward.
reduce_gradients`), exact when shards hold unequal numbers of real graphs,
as the final partial batch of an epoch does.  Parameters and optimizer
state stay replicated: every rank applies the same reduced gradients.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from connectome_gnn_tpu_torch.data.batch import ConnectomeBatch
from connectome_gnn_tpu_torch.data.dense import DenseConnectomeBatch
from connectome_gnn_tpu_torch.data.sampled import HopBlock, SampledNodeBatch
from connectome_gnn_tpu_torch.nn.layers import region_major
from connectome_gnn_tpu_torch.parallel.mesh import Mesh
from connectome_gnn_tpu_torch.parallel.shard_forward import (
    masked_ce_sum,
    reduce_gradients,
    synced_batch_norm,
    use_shard_generators,
)


def stack_batches(batches: Sequence):
    """Stack per-shard batches (identical static shapes, as the sharded
    loaders make them) leaf-wise into a leading shard axis; the result is
    the same batch class with ``[D, ...]`` tensors and the per-shard
    ``num_graphs`` / ``num_seeds``."""
    first = batches[0]
    return dataclasses.replace(first, **{
        f.name: torch.stack([getattr(b, f.name) for b in batches])
        for f in dataclasses.fields(first) if isinstance(getattr(first, f.name), torch.Tensor)
    })


def shard_batch(stacked, mesh: Mesh, axis_name: str = "data"):
    """Place a stacked batch, all shards or this process's, as the rank's
    local stack on its device (:meth:`Mesh.place`)."""
    mesh.axis_size(axis_name)
    return mesh.place(stacked)


def is_stacked(batch) -> bool:
    """Whether ``batch`` carries a leading shard axis."""
    return batch.label_mask.dim() == 2


def merge_shards(stacked):
    """A stacked batch's shards as one batch, shard-major: the batch a
    rank runs.  COO ids are offset per shard; padding ids go one past the
    merged end, and ``ptr``/``row_ptr`` are the merged cumulative counts."""
    S = int(stacked.label_mask.shape[0])
    if isinstance(stacked, SampledNodeBatch):
        return merge_sampled([dataclasses.replace(stacked, **{
            f.name: getattr(stacked, f.name)[s] for f in dataclasses.fields(stacked)
            if isinstance(getattr(stacked, f.name), torch.Tensor)
        }) for s in range(S)])
    if isinstance(stacked, DenseConnectomeBatch):
        return DenseConnectomeBatch(
            node_features=stacked.node_features.flatten(0, 1), adj=stacked.adj.flatten(0, 1),
            node_mask=stacked.node_mask.flatten(0, 1), labels=stacked.labels.flatten(),
            label_mask=stacked.label_mask.flatten(), num_graphs=S * stacked.num_graphs,
        )
    if not isinstance(stacked, ConnectomeBatch):
        raise TypeError(f"cannot merge a {type(stacked).__name__}")
    P, B = int(stacked.node_features.shape[1]), int(stacked.num_graphs)
    dev = stacked.senders.device

    def offset(ids, size, pad):
        shift = torch.arange(S, device=dev)[:, None] * size
        return torch.where(ids >= size, pad, ids + shift).flatten()

    def cumulative(ptr):
        counts = torch.diff(ptr, dim=1).flatten()
        return torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])

    return ConnectomeBatch(
        node_features=stacked.node_features.flatten(0, 1),
        senders=offset(stacked.senders, P, S * P),
        receivers=offset(stacked.receivers, P, S * P),
        edge_weight=stacked.edge_weight.flatten(),
        node_graph_ids=offset(stacked.node_graph_ids, B, S * B),
        node_mask=stacked.node_mask.flatten(),
        edge_mask=stacked.edge_mask.flatten(),
        labels=stacked.labels.flatten(),
        label_mask=stacked.label_mask.flatten(),
        ptr=cumulative(stacked.ptr),
        row_ptr=cumulative(stacked.row_ptr),
        num_graphs=S * B,
    )


def sampled_regions(batch: SampledNodeBatch) -> list[int]:
    """A sampled batch's node regions: the seeds, then (multiset hop blocks,
    whose draws are contiguous runs) each hop's draws, else the rest."""
    blocks = batch.hop_blocks
    S, N = batch.num_seeds, batch.num_nodes
    if blocks and blocks[0].sender_start is not None:
        return [S] + [int(b.weights.numel()) for b in blocks]
    return [S, N - S] if N > S else [S]


def merge_sampled(batches) -> SampledNodeBatch:
    """Per-shard sampled batches of equal static shapes as the one batch a
    rank runs, region by region (:func:`sampled_regions`): every shard's
    seeds first, where the models read their logits, then every shard's
    next region.  Node ids, edges and hop blocks are renumbered; a multiset
    batch's hop blocks stay contiguous slices (their starts scale by the
    shard count); ``shard_regions`` records the layout for dropout."""
    first = batches[0]
    D = len(batches)
    regions = sampled_regions(first)
    starts = np.cumsum([0] + regions[:-1]).tolist()
    shard_base = torch.arange(D, device=first.node_features.device)

    def stack(name):
        return torch.stack([getattr(b, name) for b in batches])

    def renumber(ids):  # ids [D, ...] shard-local → merged
        # region by region from Python ints: no host-to-device copy, so a
        # captured step can hold it
        shard = shard_base.view((D,) + (1,) * (ids.dim() - 1))
        out = ids
        for start, length in zip(starts, regions):
            inside = (ids >= start) & (ids < start + length)
            out = torch.where(inside, ids + (D - 1) * start + shard * length, out)
        return out

    blocks = None
    if first.hop_blocks is not None:
        blocks = []
        for h, b in enumerate(first.hop_blocks):
            hb = [x.hop_blocks[h] for x in batches]
            blocks.append(HopBlock(
                senders=renumber(torch.stack([x.senders for x in hb])).flatten(0, 1),
                weights=torch.stack([x.weights for x in hb]).flatten(0, 1),
                recv=renumber(torch.stack([x.recv for x in hb])).flatten(),
                sender_start=None if b.sender_start is None else D * b.sender_start,
                recv_start=None if b.recv_start is None else D * b.recv_start,
            ))
        blocks = tuple(blocks)
    return SampledNodeBatch(
        node_features=region_major(stack("node_features"), regions),
        senders=renumber(stack("senders")).flatten(),
        receivers=renumber(stack("receivers")).flatten(),
        edge_weight=stack("edge_weight").flatten(),
        node_mask=region_major(stack("node_mask"), regions),
        labels=stack("labels").flatten(),
        label_mask=stack("label_mask").flatten(),
        seed_mask=stack("seed_mask").flatten(),
        node_ids=region_major(stack("node_ids"), regions),
        num_seeds=D * first.num_seeds,
        hop_blocks=blocks,
        shard_regions=tuple(regions) if D > 1 else None,
    )


def dp_loss_and_grads(model: torch.nn.Module, mesh: Mesh, stacked):
    """Forward and backward of a data-parallel step in train mode: the
    rank's shards as one batch, sync-BatchNorm over the mesh, backward of
    the local loss sum, then the gradients reduced and normalized
    (:func:`reduce_gradients`).  Returns the global ``(loss, n)``."""
    batch = merge_shards(stacked)
    model.train()
    with synced_batch_norm(model, mesh):
        logits = model(batch)
    local_sum, local_n = masked_ce_sum(logits, batch.labels, batch.label_mask)
    local_sum.backward()
    return reduce_gradients(mesh, list(model.parameters()), local_sum, local_n)


def dp_eval_sums(model: torch.nn.Module, mesh: Mesh, stacked) -> torch.Tensor:
    """Eval mode: ``[Σ loss, correct, n_real]`` over every shard of the
    mesh, the same on every rank."""
    batch = merge_shards(stacked)
    model.eval()
    with torch.no_grad():
        logits = model(batch)
        loss_sum, n = masked_ce_sum(logits, batch.labels, batch.label_mask)
        correct = ((logits.argmax(dim=1) == batch.labels) & batch.label_mask).sum()
        return mesh.all_reduce(torch.stack([loss_sum, correct.to(loss_sum.dtype), n]))


def make_dp_train_step(model, optimizer: torch.optim.Optimizer, mesh: Mesh,
                       axis_name: str = "data", guard: bool = False, seed: int = 0):
    """A data-parallel train step: ``step(stacked) -> (loss, n)``, or
    ``(loss, n, ok)`` with ``guard`` (the non-finite step guard of
    ``train/fault.py`` on the global verdict: a rejected step keeps every
    old value and reports 0, 0, 0).  ``model`` and ``optimizer`` update in
    place; dropout draws each shard's mask from its own generator, seeded
    from ``seed`` (:meth:`Mesh.shard_generators`)."""
    from connectome_gnn_tpu_torch.train.trainer import guarded_step

    mesh.axis_size(axis_name)
    use_shard_generators(model, mesh, seed)

    def step(stacked):
        out = guarded_step(model, optimizer, lambda: dp_loss_and_grads(model, mesh, stacked),
                           guard)
        return out if guard else out[:2]

    return step


def make_dp_eval_step(model, mesh: Mesh, axis_name: str = "data"):
    """A data-parallel eval step: ``step(stacked) -> (loss_sum, correct,
    n_real)`` over the whole mesh, as device scalars."""
    mesh.axis_size(axis_name)

    def step(stacked):
        sums = dp_eval_sums(model, mesh, stacked)
        return sums[0], sums[1], sums[2]

    return step
