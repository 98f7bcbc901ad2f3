"""Exact data parallelism for batched graph classification.

The port of ``connectome_gnn_tpu/parallel/data_parallel.py``.  A batch is
sharded over the mesh's ``"data"`` axis as a *stacked* batch: the loader's
``num_shards`` collates one batch per shard and :func:`stack_batches`
stacks them leaf-wise into ``[D_local, ...]`` tensors.

Graphs are independent, so a rank runs its shards as one batch
(:func:`merge_shards`, no loop over shards); what crosses shards is only
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

import torch

from connectome_gnn_tpu_torch.data.batch import ConnectomeBatch
from connectome_gnn_tpu_torch.data.dense import DenseConnectomeBatch
from connectome_gnn_tpu_torch.parallel.mesh import Mesh
from connectome_gnn_tpu_torch.parallel.shard_forward import (
    masked_ce_sum,
    reduce_gradients,
    synced_batch_norm,
    use_shard_generators,
)


def stack_batches(batches: Sequence):
    """Stack per-shard batches (identical static shapes, as the sharded
    loader makes them) leaf-wise into a leading shard axis; the result is
    the same batch class with ``[D, ...]`` tensors and the per-shard
    ``num_graphs``."""
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
