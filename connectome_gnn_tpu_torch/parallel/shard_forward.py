"""What every sharded model and train step shares.

The port of ``connectome_gnn_tpu/parallel/shard_forward.py``.  A sharded
giant-graph model runs all of a rank's shards at once, over a local stack
``[D_local, ...]`` (:class:`ShardForwardMixin`), and its train steps follow
one gradient rule (:func:`reduce_gradients`):

* each rank runs backward on its **local** loss sum, the sum over its
  shards of the masked cross-entropy; the collectives inside the forward
  carry their own backward (:mod:`~connectome_gnn_tpu_torch.parallel.mesh`),
  so a parameter's gradient on rank ``r`` is the global sum's gradient with
  respect to rank ``r``'s copy of it;
* then the parameter gradients are all-reduced **once** and divided by the
  global count of real examples, exact when shards hold unequal counts.

A ``psum`` of the loss inside the forward, or a second all-reduce of the
gradients, would count every gradient once per rank: JAX's
``apply_global_update`` warns of the same trap, where ``shard_map``'s
autodiff delivers the cotangents of replicated inputs already summed.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
import torch.nn.functional as F

from connectome_gnn_tpu_torch.nn.layers import Dropout, MaskedBatchNorm
from connectome_gnn_tpu_torch.parallel.mesh import Mesh


class ShardForwardMixin:
    """Adds ``forward(sharded, mesh, axis_name=...)`` around a model's
    ``apply_shard``: the model runs every local shard of ``sharded`` (a
    partitioned graph whose tensors carry the leading ``[D_local]`` axis)
    in the module's mode and returns per-node logits ``[D_local, P, C]``.
    BatchNorm statistics are summed over every shard of the mesh."""

    def forward(self, sharded, mesh: Mesh, *, axis_name: str = "edge") -> torch.Tensor:
        check_sharded(sharded, mesh, axis_name)
        with synced_batch_norm(self, mesh):
            return self.apply_shard(sharded, mesh, axis_name=axis_name)


def use_shard_generators(model: torch.nn.Module, mesh: Mesh, seed: int) -> list:
    """``model``'s :class:`Dropout` layers draw each local shard's mask from
    its own generator (:meth:`Mesh.shard_generators`); returns them."""
    gens = mesh.shard_generators(seed)
    for module in model.modules():
        if isinstance(module, Dropout):
            module.shard_generators = gens
    return gens


def check_sharded(sharded, mesh: Mesh, axis_name: str) -> None:
    """Refuse a partition that does not fit the mesh: its global shard count
    must be ``axis_name``'s size and its local stack the rank's shards."""
    if sharded.num_shards != mesh.axis_size(axis_name):
        raise ValueError(f"the graph is partitioned into {sharded.num_shards} shards; the mesh's "
                         f"{axis_name!r} axis has {mesh.axis_size(axis_name)}")
    lead = int(sharded.node_features.shape[0])
    if lead != mesh.local_shards:
        raise ValueError(f"the local stack holds {lead} shards; this rank owns "
                         f"{mesh.local_shards} (place it with mesh.place)")


def moment_reducer(mesh: Mesh):
    """Sync-BatchNorm's reducer: ``(n, Σx, Σx²)`` summed over ranks in one
    all-reduce (the rank's shards are already in its sums); the backward
    reduces the sums' cotangents, not the count's."""

    def reduce(n, sum_x, sum_x2):
        k = sum_x.numel()
        flat = mesh.all_reduce(torch.cat([n.detach().reshape(1).to(sum_x.dtype), sum_x.reshape(-1),
                                          sum_x2.reshape(-1)]), constant_prefix=1)
        total_n, total_x, total_x2 = flat.split([1, k, k])
        # the count is data, not a function of the parameters
        return total_n.detach()[0], total_x.view(sum_x.shape), total_x2.view(sum_x2.shape)

    return reduce


@contextlib.contextmanager
def synced_batch_norm(model: torch.nn.Module, mesh: Mesh):
    """Inside, ``model``'s :class:`MaskedBatchNorm` layers sum their batch
    moments over the mesh."""
    norms = [m for m in model.modules() if isinstance(m, MaskedBatchNorm)]
    reducer = moment_reducer(mesh)
    for m in norms:
        m.moment_reducer = reducer
    try:
        yield
    finally:
        for m in norms:
            m.moment_reducer = None


def masked_ce_sum(logits: torch.Tensor, labels: torch.Tensor, label_mask: torch.Tensor):
    """``(Σ ce · mask, Σ mask)`` over every leading axis: the local loss sum
    and count."""
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long(),
                         reduction="none")
    mask = label_mask.reshape(-1).to(logits.dtype)
    return (ce * mask).sum(), mask.sum()


def reduce_gradients(mesh: Mesh, params: Sequence[torch.nn.Parameter], local_sum: torch.Tensor,
                     local_n: torch.Tensor):
    """After ``local_sum.backward()``: all-reduce the gradients once and
    divide them by the global count of real examples.  Returns the global
    mean loss and the count, ``(loss, n)``."""
    sums = torch.stack([local_sum.detach(), local_n.detach().to(local_sum.dtype)])
    mesh.reduce_(sums, "psum")
    n = torch.clamp(sums[1], min=1.0)
    grads = [p.grad for p in params if p.grad is not None]
    if grads:
        # one flat buffer: one all-reduce and one division for every gradient
        flat = torch.cat([g.reshape(-1) for g in grads])
        mesh.reduce_(flat, "gradient all_reduce")
        flat.div_(n)
        torch._foreach_copy_(grads, [v.view_as(g) for v, g in
                                     zip(flat.split([g.numel() for g in grads]), grads)])
    return sums[0] / n, n


def apply_global_update(mesh: Mesh, optimizer: torch.optim.Optimizer,
                        params: Sequence[torch.nn.Parameter], local_sum: torch.Tensor,
                        local_n: torch.Tensor):
    """:func:`reduce_gradients`, then the optimizer's step; ``(loss, n)``."""
    loss, n = reduce_gradients(mesh, params, local_sum, local_n)
    optimizer.step()
    return loss, n


def make_node_train_step(model, optimizer: torch.optim.Optimizer, mesh: Mesh, axis_name: str,
                         seed: int = 0):
    """A node-classification train step over a partitioned graph:
    ``step(sharded) -> (loss, n)``, the masked mean cross-entropy over the
    labelled nodes of every shard and their count, with ``model`` and
    ``optimizer`` updated in place (:func:`apply_global_update`).  Dropout
    draws each shard's mask from its own generator, seeded from ``seed``;
    at dropout 0 the step is one device's."""
    params = list(model.parameters())
    use_shard_generators(model, mesh, seed)

    def step(sharded):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        logits = model(sharded, mesh, axis_name=axis_name)
        local_sum, local_n = masked_ce_sum(logits, sharded.labels, sharded.label_mask)
        local_sum.backward()
        return apply_global_update(mesh, optimizer, params, local_sum, local_n)

    return step
