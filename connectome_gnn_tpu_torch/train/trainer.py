"""Training, evaluation and serving loop for connectome GNN classifiers.

The port of ``connectome_gnn_tpu.train.trainer.Trainer`` in single-device
mode (``trainer.py:36-456`` and ``:572-923``): masked cross-entropy, L2-Adam
(:func:`reference_adam`), per-epoch train and validation with the loss
weighted by the real graph count, early stopping on validation loss with
patience, a best-weights snapshot restored at the end, the non-finite step
guard, preemption handling and atomic fit checkpoints that resume bitwise.
Padded graph slots are excluded from loss and metrics by ``label_mask`` and
from predictions by ``graph_mask``.

:meth:`Trainer.predict` serves per-graph logits through :func:`~
connectome_gnn_tpu_torch.ops.fused.forward_auto` (the fused kernels K1/K2 on
CUDA).  Training runs no hand-written kernel: the JAX train step is
``model.apply`` under ``value_and_grad`` plus optax, here autograd plus
``torch.optim.Adam``.

Sampled node training goes through the same loop: host-sampled
:class:`~connectome_gnn_tpu_torch.data.sampled.SampledNodeBatch` es and
device-sampled :class:`~connectome_gnn_tpu_torch.data.device_sampling.
SeedBatch` es (through a ``DeviceSampledModel``) train, evaluate, fit and
predict unchanged.  ``scan_epochs`` runs a device-sampled epoch from one
uploaded buffer: on the card as one captured CUDA graph a step, replayed
per row (the analog of the JAX package's ``lax.scan`` epoch).

``Trainer(mesh=...)`` trains graph classification data-parallel over a
:class:`~connectome_gnn_tpu_torch.parallel.mesh.Mesh` (``trainer.py:64-68``
and ``:134-162`` of the JAX package): loaders yield stacked batches
(``ConnectomeDataLoader(num_shards=D)``), each rank runs its shards as one
batch with sync-BatchNorm, and the step reduces the gradients once over
the mesh (``parallel/data_parallel.py``); the guard decides on the global
values, so every rank takes the same verdict.  ``evaluate`` and ``predict``
sum and gather over the mesh.  Sampled node training runs over a mesh too
(``trainer.py:260-540`` of the JAX package): stacked host-sampled batches
(``SampledNodeLoader(num_shards=D)``), stacked seed rows of a sharded
``DeviceSeedLoader`` against a CSR replicated to the mesh's device
(``parallel/sampled_dp.py``; ``scan_epochs`` replays one captured step,
collectives included), and a ``GraphShardedSampledModel``'s graph-sharded
steps (``parallel/sharded_sampling.py``), whose exchange overflow is
``last_sampling_overflow``.
The JAX Trainer's ``params`` / ``state`` arguments have no counterpart:
the port's model carries its weights (``models.compat.load_jax_params``
loads JAX ones).
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Callable, Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from connectome_gnn_tpu_torch.data.batch import card_by_default
from connectome_gnn_tpu_torch.data.prefetch import PrefetchIterator
from connectome_gnn_tpu_torch.nn.layers import Dropout
from connectome_gnn_tpu_torch.ops.fused import forward_auto
from connectome_gnn_tpu_torch.train.checkpoint import load_arrays, restore_checkpoint, save_checkpoint
from connectome_gnn_tpu_torch.train.fault import (
    PreemptionGuard,
    all_finite,
    guard_step_outputs,
    snapshot,
)

#: builds the optimizer over the model's parameters (after they are moved)
OptimizerFactory = Callable[[Iterable[torch.nn.Parameter]], torch.optim.Optimizer]


def reference_adam(learning_rate: float = 1e-3, weight_decay: float = 1e-4) -> OptimizerFactory:
    """The reference recipe ``torch.optim.Adam(lr, weight_decay)``: L2
    weight decay added to the gradient before the moments (not AdamW),
    which the JAX package writes ``optax.chain(add_decayed_weights(wd),
    adam(lr))`` (``trainer.py:36-45``).

    Returns a factory over the parameters.  On CUDA parameters the Adam is
    ``capturable``, which keeps its step count on the card: the non-finite
    guard can then roll the count back without a host sync."""

    def make(params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
        params = list(params)
        on_card = bool(params) and params[0].device.type == "cuda"
        return torch.optim.Adam(params, lr=learning_rate, weight_decay=weight_decay,
                                capturable=on_card)

    return make


def _optimizer_tensors(optimizer, params) -> list:
    """``(param, key, tensor)`` of the optimizer's state, in parameter order."""
    return [(p, k, v) for p in params for k, v in optimizer.state.get(p, {}).items()
            if torch.is_tensor(v)]


def guarded_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer, loss_and_grads,
                 guard: bool):
    """One optimization step: ``loss_and_grads()`` runs the forward and the
    backward and returns ``(loss, n)``; then the optimizer steps.  With
    ``guard`` it is the non-finite step guard (``train/fault.py``): a step
    with a non-finite loss, gradient or buffer keeps every old value.
    Returns ``(loss, n, ok)`` as device scalars (a rejected step gives 0,
    0, 0)."""
    params, buffers = list(model.parameters()), list(model.buffers())
    if guard:
        opt_before = _optimizer_tensors(optimizer, params)
        old = snapshot([p.detach() for p in params] + buffers + [v for _, _, v in opt_before])
    optimizer.zero_grad(set_to_none=True)
    loss, n = loss_and_grads()
    if not guard:
        optimizer.step()
        return loss, n, torch.ones((), device=n.device)
    ok = all_finite(loss, *(p.grad for p in params if p.grad is not None), *buffers)
    optimizer.step()
    # the snapshot's tensors in its order, then state the step created
    # lazily (restored to its zeros)
    seen = {(p, k) for p, k, _ in opt_before}
    state = [optimizer.state[p][k] for p, k, _ in opt_before]
    state += [v for p, k, v in _optimizer_tensors(optimizer, params) if (p, k) not in seen]
    with torch.no_grad():
        return guard_step_outputs(ok, [p.detach() for p in params] + buffers + state, old, loss, n)


class Trainer:
    """Trains, evaluates and serves a :class:`GCNConnectome` /
    :class:`GraphSAGEConnectome` on one device.

    Parameters
    ----------
    model
        The model with its weights; it is moved to ``device``.
    optimizer
        A factory ``params -> torch.optim.Optimizer``; default
        :func:`reference_adam` (Adam lr 1e-3 with L2 weight decay 1e-4).
    seed
        Seeds the trainer's generator, from which every :class:`~
        connectome_gnn_tpu_torch.nn.layers.Dropout` of the model draws (the
        model's weights come from its own constructor).  The generator's
        state is part of the fit checkpoint, so a resumed run replays the
        dropout masks.
    device
        Where the model runs (default: ``cuda``; without a CUDA card that
        raises ``RuntimeError``, and ``device="cpu"`` asks for the CPU).
        Batches from a loader on another device are moved here.
    skip_nonfinite
        The non-finite step guard (on by default, ``train/fault.py``): a
        step whose loss, gradients or BatchNorm update hold a non-finite
        value keeps the old parameters, buffers and optimizer state
        (Adam's step count included), adds nothing to the epoch's loss and
        counts in ``last_skipped_steps`` (``fit``'s history
        ``skipped_steps``).  When every value is finite it is the identity,
        bitwise.  It reads nothing back from the device, so a step needs no
        host sync when the optimizer keeps its state on the device, as
        :func:`reference_adam` does.
    prefetch_depth
        Batches a background thread collates and copies ahead of the device
        (default 2; 0 iterates the loader in line).  Reorders nothing.
    mesh / axis_name
        A :class:`~connectome_gnn_tpu_torch.parallel.mesh.Mesh`: train
        data-parallel over its ``axis_name`` axis (default ``"data"``).
        Loaders must then yield stacked batches of the mesh's shard count
        (``ConnectomeDataLoader(..., num_shards=D)``, with ``process_index``
        / ``process_count`` where there are several processes); the model
        runs on the mesh's device.  Dropout draws each shard's mask from
        its own generator, seeded from ``seed`` and the shard's index.
        Numerics are single-device training's at the global batch, up to
        the order of float32 sums.  Sampled loaders shard the same way
        (``SampledNodeLoader`` / ``DeviceSeedLoader`` with ``num_shards``);
        a ``GraphShardedSampledModel`` trains from its ``make_loader``, its
        partition placed once on the mesh's device.
    scan_epochs
        For a ``DeviceSampledModel`` trained from a ``DeviceSeedLoader``:
        each training epoch is packed into one ``[steps, 3 + 2S]`` buffer
        (``pack_epoch``) and uploaded once.  On the card one train step
        (sampling, forward, backward, the guard, Adam) is captured as a
        CUDA graph once per trainer and shape, after one eager step of the
        first epoch; every other step copies its row into the graph's input
        slot on the device and replays it.  On the CPU the same steps run
        from the buffer without a capture.  The steps are the stepwise
        loop's, so ``fit``, early stopping, checkpoints and the guard work
        unchanged (on the CPU the two are bitwise equal).  A failed capture
        raises; nothing falls back to eager steps on the card.  Other
        loaders train stepwise.  Over a mesh the loader must be sharded
        (``num_shards=D``) and the captured step holds the sync-BatchNorm
        and gradient collectives; the mesh's counters grow by the captured
        step's counts a replay.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        optimizer: Optional[OptimizerFactory] = None,
        seed: int = 0,
        device=None,
        skip_nonfinite: bool = True,
        prefetch_depth: int = 2,
        scan_epochs: bool = False,
        mesh=None,
        axis_name: str = "data",
    ):
        self.mesh = mesh
        self.axis_name = axis_name
        if mesh is not None:
            mesh.axis_size(axis_name)
            if device is not None and torch.empty(0, device=device).device != mesh.device:
                raise ValueError(f"device={device} is not the mesh's device {mesh.device}")
            device = mesh.device
        self.device = torch.device(card_by_default(device, "Trainer"))
        self.model = model.to(self.device)
        if hasattr(getattr(self.model, "csr", None), "gather_features"):
            # a DeviceGraphCSR; a graph-sharded model's partition is placed
            # on the mesh's device by the Trainer
            self._check_csr(self.model.csr, "the model's")
        self.optimizer = (optimizer or reference_adam())(self.model.parameters())
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))
        #: mesh mode: each local shard's dropout generator
        self.shard_generators = mesh.shard_generators(seed) if mesh is not None else None
        for module in self.model.modules():
            if isinstance(module, Dropout):
                module.generator = self.generator
                module.shard_generators = self.shard_generators
        self.skip_nonfinite = bool(skip_nonfinite)
        self.prefetch_depth = int(prefetch_depth)
        self.last_skipped_steps = 0
        #: graph-sharded training: request slots the compacted exchange
        #: dropped over the last epoch, summed over the mesh (0: exact)
        self.last_sampling_overflow = 0
        self._warned_unfusable = False
        self.scan_epochs = bool(scan_epochs)
        #: (row shape, labelled, CSR) → the captured step (``scan_epochs`` on the card)
        self._captured: dict = {}
        #: mesh mode: the replicated CSRs and placed partitions (by identity)
        #: and the graph-sharded steps (by train and compaction config)
        self._csr_cache: dict = {}
        self._gs_csr_cache: dict = {}
        self._gs_cache: dict = {}
        self._step_overflow = None

    def _iterate(self, loader):
        """Iterate ``loader``, ``prefetch_depth`` batches ahead in a
        background thread, each batch on the trainer's device."""
        if self.prefetch_depth <= 0:
            for batch in loader:
                yield batch.to(self.device)
            return
        it = PrefetchIterator(loader, depth=self.prefetch_depth)
        try:
            for batch in it:
                yield batch.to(self.device)
        finally:
            it.close()

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------

    def _train_step(self, batch):
        """One optimization step; returns ``(loss, n, ok)`` as device
        scalars (a rejected step gives 0, 0, 0)."""
        self._step_overflow = None
        if self.mesh is not None and self._is_seed_batch(batch) and self._is_graph_sharded():
            out = self._graph_sharded_step(train=True)(
                self._placed_sharded_csr(), batch.seeds, batch.key_words, batch.labels,
                batch.label_mask)
            if self.model.compaction is not None:
                self._step_overflow = out[2]
            ok = out[-1] if self.skip_nonfinite else torch.ones((), device=out[1].device)
            return out[0], out[1], ok
        return guarded_step(self.model, self.optimizer, lambda: self._loss_and_grads(batch),
                            self.skip_nonfinite)

    def _loss_and_grads(self, batch):
        """Forward and backward of one step; the mean loss and the count of
        labelled graphs (over the whole mesh in mesh mode)."""
        if self.mesh is not None:
            from connectome_gnn_tpu_torch.parallel.data_parallel import dp_loss_and_grads
            from connectome_gnn_tpu_torch.parallel.sampled_dp import dp_seed_loss_and_grads

            if self._is_seed_batch(batch):
                return dp_seed_loss_and_grads(self.model, self.mesh, batch.packed,
                                              self._replicated_csr(batch), batch.labeled)
            return dp_loss_and_grads(self.model, self.mesh, self._stacked(batch))
        logits = self.model(batch)
        ce = F.cross_entropy(logits, batch.labels, reduction="none")
        mask = batch.label_mask.to(logits.dtype)
        n = mask.sum()
        loss = (ce * mask).sum() / torch.clamp(n, min=1.0)
        loss.backward()
        return loss.detach(), n

    def _loader_hint(self, loader: str) -> str:
        return (f"a {loader} with num_shards={self.mesh.axis_size(self.axis_name)}"
                + (f", process_index={self.mesh.rank}, process_count={self.mesh.world}"
                   if self.mesh.world > 1 else ""))

    def _stacked(self, batch):
        """Mesh mode: ``batch``, checked to be a stacked graph or sampled
        batch of the rank's shards."""
        from connectome_gnn_tpu_torch.data.batch import ConnectomeBatch
        from connectome_gnn_tpu_torch.data.dense import DenseConnectomeBatch
        from connectome_gnn_tpu_torch.data.sampled import SampledNodeBatch
        from connectome_gnn_tpu_torch.parallel.data_parallel import is_stacked

        if not isinstance(batch, (ConnectomeBatch, DenseConnectomeBatch, SampledNodeBatch)):
            raise TypeError(f"mesh mode cannot train a {type(batch).__name__}")
        if not is_stacked(batch) or batch.label_mask.shape[0] != self.mesh.local_shards:
            loader = ("SampledNodeLoader" if isinstance(batch, SampledNodeBatch)
                      else "ConnectomeDataLoader")
            raise ValueError(
                f"mesh-mode training needs stacked batches of this rank's {self.mesh.local_shards} "
                f"shards: {self._loader_hint(loader)}")
        return batch

    # ------------------------------------------------------------------
    # Mesh mode: device-sampled and graph-sharded seed batches
    # ------------------------------------------------------------------

    def _is_seed_batch(self, batch) -> bool:
        """Whether ``batch`` is a ``SeedBatch``; in mesh mode it must be the
        rank's stacked rows (a sharded ``DeviceSeedLoader``'s)."""
        from connectome_gnn_tpu_torch.data.device_sampling import SeedBatch

        if not isinstance(batch, SeedBatch):
            return False
        if not batch.stacked or batch.packed.shape[0] != self.mesh.local_shards:
            raise ValueError(
                "mesh-mode training needs a sharded DeviceSeedLoader yielding stacked "
                f"SeedBatches of this rank's {self.mesh.local_shards} shards: "
                + self._loader_hint("DeviceSeedLoader"))
        return True

    def _is_graph_sharded(self) -> bool:
        from connectome_gnn_tpu_torch.parallel.sharded_sampling import GraphShardedSampledModel

        return isinstance(self.model, GraphShardedSampledModel)

    def _replicated_csr(self, batch):
        """The batch's (or the model's) CSR on the mesh's device, cached by
        identity: a one-time copy."""
        csr = batch.csr if batch.csr is not None else getattr(self.model, "csr", None)
        if csr is None:
            raise ValueError("stacked SeedBatch training needs a DeviceGraphCSR (build the loader "
                             "with model.make_loader or pass csr=)")
        key = id(csr)
        if key not in self._csr_cache:
            from connectome_gnn_tpu_torch.parallel.sampled_dp import replicate_csr

            self._csr_cache[key] = csr, replicate_csr(csr, self.mesh)
        return self._csr_cache[key][1]

    def _placed_sharded_csr(self):
        """The model's partition placed for this rank (``shard_csr``), cached
        by identity; refuses a partition of another shard count."""
        from connectome_gnn_tpu_torch.parallel.sharded_sampling import shard_csr

        csr = self.model.csr
        D = self.mesh.axis_size(self.axis_name)
        if csr.num_shards != D:
            raise ValueError(
                f"graph-sharded model has {csr.num_shards} shards but the mesh axis "
                f"'{self.axis_name}' has {D}: repartition (graph_sharded_sage(graph, "
                f"num_shards={D}, ...)) or build a matching mesh")
        key = id(csr)
        if key not in self._gs_csr_cache:
            self._gs_csr_cache.clear()  # a swapped partition drops the old placement
            self._gs_csr_cache[key] = csr, shard_csr(csr, self.mesh, self.axis_name)
        return self._gs_csr_cache[key][1]

    def _graph_sharded_step(self, train: bool):
        """The graph-sharded train or eval step for the model's current
        compaction config, cached; steps of a superseded config are dropped
        (``GraphShardedSampledModel.plan_compaction`` may re-plan mid-run)."""
        from connectome_gnn_tpu_torch.parallel.sharded_sampling import (
            make_graph_sharded_eval_step,
            make_graph_sharded_train_step,
        )

        m = self.model
        key = (train, m.compaction)
        if key not in self._gs_cache:
            for stale in [k for k in self._gs_cache if k[1] != m.compaction]:
                del self._gs_cache[stale]
            if train:
                self._gs_cache[key] = make_graph_sharded_train_step(
                    m.inner, self.optimizer, self.mesh, m.fanout, self.axis_name,
                    guard=self.skip_nonfinite, compaction=m.compaction, seed=None)
            else:
                self._gs_cache[key] = make_graph_sharded_eval_step(
                    m.inner, self.mesh, m.fanout, self.axis_name, compaction=m.compaction)
        return self._gs_cache[key]

    def _train_steps(self, loader):
        """Every step of one pass over ``loader``; returns the device sums
        ``[Σ loss·n, Σ n, Σ ok, Σ overflow]`` (None for an empty loader) and
        the number of steps.  Nothing is read back from the device."""
        self.model.train()
        sums, steps = None, 0
        for batch in self._iterate(loader):
            loss, n, ok = self._train_step(batch)
            ovf = self._step_overflow if self._step_overflow is not None else torch.zeros_like(n)
            step = torch.stack([loss * n, n, ok, ovf.to(n.dtype)])
            sums = step if sums is None else sums + step
            steps += 1
        return sums, steps

    def _scannable(self, loader) -> bool:
        """Whether ``scan_epochs`` takes ``loader``'s epoch (``trainer.py:
        458-482`` of the JAX package): a ``DeviceSeedLoader`` is scanned,
        other loaders train stepwise, and what a scan cannot run raises."""
        from connectome_gnn_tpu_torch.data.device_sampling import (
            DeviceSampledModel,
            DeviceSeedLoader,
        )

        if not isinstance(loader, DeviceSeedLoader):
            return False
        if self.mesh is None:
            if loader.num_shards is not None:
                raise ValueError("scan_epochs without a mesh needs an unsharded DeviceSeedLoader")
        else:
            if self._is_graph_sharded():
                raise ValueError("scan_epochs is not supported for graph-sharded models (the "
                                 "scanned epoch runs the replicated device-sampled path)")
            if loader.num_shards != self.mesh.axis_size(self.axis_name) or \
                    loader.row_shape[0] != self.mesh.local_shards:
                raise ValueError("scan_epochs over a mesh needs a sharded DeviceSeedLoader: "
                                 + self._loader_hint("DeviceSeedLoader"))
        if not isinstance(self.model, DeviceSampledModel):
            raise ValueError(
                "scan_epochs samples on the device: the model must be a DeviceSampledModel "
                f"(got {type(self.model).__name__})"
            )
        if loader.csr is not None:
            self._check_csr(loader.csr, "scan_epochs: the loader's")
        if self.device.type == "cuda" and not all(
            g.get("capturable", True) for g in self.optimizer.param_groups
        ):
            raise ValueError("scan_epochs on the card captures the step: the optimizer must be "
                             "capturable (reference_adam's is)")
        return True

    def _check_csr(self, csr, whose: str) -> None:
        """Refuse a ``DeviceGraphCSR`` on another device than the trainer's."""
        if csr.device != torch.empty(0, device=self.device).device:
            raise ValueError(
                f"{whose} DeviceGraphCSR lies on {csr.device} and the Trainer runs on "
                f"{self.device}: the CSR does not move with the model; build it on the "
                "Trainer's device (from_graph(device=...))"
            )

    def _seed_step(self, row, csr, num_seeds: int, labeled: bool, acc) -> None:
        """One train step on a packed seed row (the rank's stacked rows in
        mesh mode), its ``[loss·n, n, ok, 0]`` added into ``acc`` in place
        (the scanned epoch's body)."""
        from connectome_gnn_tpu_torch.data.device_sampling import SeedBatch

        batch = SeedBatch(packed=row, csr=csr, num_seeds=num_seeds, labeled=labeled)
        loss, n, ok = self._train_step(batch)
        acc.add_(torch.stack([loss * n, n, ok, torch.zeros_like(n)]))

    def _capture(self, row0, csr, num_seeds: int, labeled: bool, acc):
        """Run ``row0``'s step eagerly on a side stream (the warm-up that
        makes the optimizer's state and every lazy handle), then capture one
        step as a CUDA graph reading a static row slot; returns ``(graph,
        slot, counts)``, ``counts`` one step's collective counts in mesh
        mode (a replay runs no Python, so the mesh's counters do not tick)."""
        from connectome_gnn_tpu_torch.parallel.sampled_dp import (
            capture_step,
            counts_of,
            keep_one_run,
        )

        slot = row0.clone()
        generators = []
        if any(isinstance(m, Dropout) and m.p > 0 for m in self.model.modules()):
            # dropout draws from the trainer's generators: each replay
            # advances them as an eager step would
            generators = self.shard_generators if self.mesh is not None else [self.generator]
        before = counts_of(self.mesh) if self.mesh is not None else None
        try:
            graph = capture_step(lambda: self._seed_step(slot, csr, num_seeds, labeled, acc),
                                 self.device, generators, list(self.model.parameters()))
        except RuntimeError as exc:
            raise RuntimeError(f"scan_epochs: {exc}") from exc
        counts = keep_one_run(self.mesh, before) if self.mesh is not None else None
        return graph, slot, counts

    def _train_steps_scanned(self, loader):
        """A ``DeviceSeedLoader``'s epoch from one uploaded buffer; the same
        return as :meth:`_train_steps`."""
        from connectome_gnn_tpu_torch.data.device_sampling import pack_epoch

        self.model.train()
        packed = pack_epoch(loader).to(self.device)  # advances the loader's epoch
        steps = int(packed.shape[0])
        if self.mesh is not None:
            csr = self._replicated_csr(loader)
        else:
            csr = loader.csr if loader.csr is not None else self.model.csr
        S, labeled = loader._shard_size, loader.node_labels is not None
        if steps == 0:
            return None, 0
        if self.device.type != "cuda":
            acc = torch.zeros(4, device=self.device)
            for row in packed:
                self._seed_step(row, csr, S, labeled, acc)
            return acc, steps
        # the graph holds its row slot and its sums by address: both live
        # with it (and the CSR, which keeps its id unique)
        key = (tuple(packed.shape[1:]), labeled, id(csr))
        if key in self._captured:
            graph, slot, acc, counts, _ = self._captured[key]
            acc.zero_()
            start = 0
        else:
            acc = torch.zeros(4, device=self.device)
            graph, slot, counts = self._capture(packed[0], csr, S, labeled, acc)
            self._captured[key] = graph, slot, acc, counts, csr
            start = 1
        for i in range(start, steps):
            slot.copy_(packed[i])
            graph.replay()
        if counts is not None:
            from connectome_gnn_tpu_torch.parallel.sampled_dp import add_replays

            add_replays(self.mesh, counts, steps - start)
        return acc.clone(), steps

    def train_epoch(self, loader) -> float:
        """One optimization pass over ``loader``; returns the mean loss per
        graph, ``Σ loss·n / Σ n`` (``trainer.py:452-456``).

        Loss, counts and the guard's flags stay on the device until the
        epoch ends: one host sync per epoch.  With ``scan_epochs`` a
        ``DeviceSeedLoader``'s epoch runs from one uploaded buffer.
        """
        if self.scan_epochs and self._scannable(loader):
            sums, steps = self._train_steps_scanned(loader)
        else:
            sums, steps = self._train_steps(loader)
        if sums is None:
            self.last_skipped_steps = self.last_sampling_overflow = 0
            return 0.0
        total, graphs, oks, overflow = sums.tolist()
        self.last_skipped_steps = steps - int(round(oks))
        self.last_sampling_overflow = int(round(overflow))
        return total / max(graphs, 1.0)

    def fit(
        self,
        train_loader,
        val_loader,
        num_epochs: int = 50,
        patience: int = 10,
        verbose: bool = True,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 1,
        resume: bool = False,
    ) -> dict:
        """Train with early stopping on validation loss (``trainer.py:
        714-844``, reference ``train.py:76-127``).

        Snapshots the weights (cloned tensors) whenever the validation loss
        improves, stops after ``patience`` epochs without improvement and
        restores the best snapshot at the end.  Returns the history:
        ``train_loss``, ``val_loss``, ``val_acc`` and ``skipped_steps``.

        With ``checkpoint_dir``, one atomic file holds the whole training
        state (parameters, BatchNorm buffers, optimizer state, the
        generator's state, the best snapshot and the bookkeeping), written
        every ``checkpoint_every`` epochs and at stop, preemption and the
        last epoch.  ``resume=True`` restores it and continues; loaders'
        ``set_epoch`` pins each epoch's shuffle, so the resumed run replays
        the uninterrupted one bitwise.  A run that had already stopped
        early returns at once.
        """
        history: dict = {"train_loss": [], "val_loss": [], "val_acc": [], "skipped_steps": []}
        verbose = verbose and (self.mesh is None or self.mesh.rank == 0)
        best_val_loss = float("inf")
        best_epoch = 0
        best = None
        start_epoch = 1

        if checkpoint_dir and resume:
            meta = self._restore_fit_checkpoint(checkpoint_dir)
            if meta is not None:
                history = meta["history"]
                best_val_loss = meta["best_val_loss"]
                best_epoch = meta["best_epoch"]
                best = self._best
                if meta["stopped_early"]:
                    # the run already finished: re-running the same job
                    # script must not train extra epochs
                    if verbose:
                        print(f"Run in {checkpoint_dir} already early-stopped at epoch "
                              f"{meta['epoch']} (best={best_epoch})")
                    self.model.load_state_dict(best)
                    return history
                start_epoch = meta["epoch"] + 1
                if verbose:
                    print(f"Resumed from {checkpoint_dir} at epoch {meta['epoch']} (best={best_epoch})")

        with PreemptionGuard() as preemption:
            for epoch in range(start_epoch, num_epochs + 1):
                for loader in (train_loader, val_loader):
                    # the validation stream is pinned too, so a resumed run
                    # replays validation exactly
                    if hasattr(loader, "set_epoch"):
                        loader.set_epoch(epoch - 1)
                train_loss = self.train_epoch(train_loader)
                val = self.evaluate(val_loader)
                history["train_loss"].append(train_loss)
                history["val_loss"].append(val["loss"])
                history["val_acc"].append(val["accuracy"])
                history["skipped_steps"].append(self.last_skipped_steps)
                if verbose:
                    skipped = self.last_skipped_steps
                    print(f"Epoch {epoch:3d} | train_loss={train_loss:.4f} | "
                          f"val_loss={val['loss']:.4f} | val_acc={val['accuracy']:.3f}"
                          + (f" | skipped={skipped}" if skipped else ""))

                if val["loss"] < best_val_loss:
                    best_val_loss, best_epoch = val["loss"], epoch
                    best = {k: v.detach().clone() for k, v in self.model.state_dict().items()}

                stop = epoch - best_epoch >= patience
                preempted = preemption.triggered
                if checkpoint_dir and (stop or preempted or epoch == num_epochs
                                       or epoch % checkpoint_every == 0):
                    self._save_fit_checkpoint(checkpoint_dir, epoch, best_epoch, best_val_loss,
                                              best, history, stop)
                if stop:
                    if verbose:
                        print(f"Early stop at epoch {epoch} (best={best_epoch})")
                    break
                if preempted:
                    # SIGTERM/SIGINT arrived: the state is saved (when
                    # checkpointing); resume=True continues from here
                    if verbose:
                        print(f"Preempted at epoch {epoch}; checkpoint "
                              + ("written" if checkpoint_dir else "NOT enabled"))
                    break

        if best is not None:
            self.model.load_state_dict(best)
        return history

    # ------------------------------------------------------------------
    # Evaluation and serving
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def evaluate(self, loader) -> dict:
        """Masked accuracy and mean loss over ``loader`` (eval mode)."""
        self.model.eval()
        sums = torch.zeros(3, device=self.device)  # loss, correct, total
        for batch in self._iterate(loader):
            if self.mesh is not None:
                sums += self._mesh_eval_sums(batch)
                continue
            logits = self.model(batch)
            ce = F.cross_entropy(logits, batch.labels, reduction="none")
            mask = batch.label_mask.to(logits.dtype)
            correct = ((logits.argmax(dim=1) == batch.labels) & batch.label_mask).sum()
            sums += torch.stack([(ce * mask).sum(), correct.to(sums.dtype), mask.sum()])
        total_loss, correct, total = sums.tolist()  # one host sync for the whole pass
        correct, total = int(correct), int(total)
        return {
            "accuracy": correct / max(total, 1),
            "loss": total_loss / max(total, 1),
            "correct": correct,
            "total": total,
        }

    def _mesh_eval_sums(self, batch) -> torch.Tensor:
        """Mesh mode: one batch's ``[Σ loss, correct, n_real]`` over the mesh."""
        from connectome_gnn_tpu_torch.parallel.data_parallel import dp_eval_sums
        from connectome_gnn_tpu_torch.parallel.sampled_dp import dp_seed_eval_sums

        if not self._is_seed_batch(batch):
            return dp_eval_sums(self.model, self.mesh, self._stacked(batch))
        if self._is_graph_sharded():
            out = self._graph_sharded_step(train=False)(
                self._placed_sharded_csr(), batch.seeds, batch.key_words, batch.labels,
                batch.label_mask)
            return torch.stack(out)
        return dp_seed_eval_sums(self.model, self.mesh, batch.packed, self._replicated_csr(batch),
                                 batch.labeled)

    def _merged_seed_batch(self, batch):
        """Mesh mode: a stacked seed batch sampled and merged as the rank
        runs it (eval-mode sampling)."""
        if self._is_graph_sharded():
            from connectome_gnn_tpu_torch.parallel.sharded_sampling import graph_sharded_batch

            m = self.model
            return graph_sharded_batch(self._placed_sharded_csr(), batch.seeds, batch.key_words,
                                       batch.labels, batch.label_mask, m.fanout, self.mesh,
                                       self.axis_name, m.compaction)[0], m.inner
        from connectome_gnn_tpu_torch.parallel.sampled_dp import sample_shards

        return sample_shards(self.model, batch.packed, self._replicated_csr(batch),
                             batch.labeled), self.model.inner

    @torch.inference_mode()
    def predict(self, loader, prefer_fused: bool = True) -> np.ndarray:
        """Per-graph logits over ``loader`` (eval mode), real graphs only.

        Returns a ``[num_real_graphs, num_classes]`` numpy array in loader
        order.  With ``prefer_fused`` (default) each batch goes through
        :func:`~connectome_gnn_tpu_torch.ops.fused.forward_auto`, which
        runs dense-layout batches on CUDA through the fused kernel; a COO
        batch cannot fuse, so it warns once and takes ``model(batch)``.

        In mesh mode each rank serves its shards as one batch, and every
        rank returns the logits of every shard, gathered over the mesh in
        loader order.
        """
        self.model.eval()
        chunks = []
        for batch in self._iterate(loader):
            graph_mask = None
            model = self.model
            if self.mesh is not None:
                from connectome_gnn_tpu_torch.parallel.data_parallel import merge_shards

                if self._is_seed_batch(batch):
                    batch, model = self._merged_seed_batch(batch)
                else:
                    batch = merge_shards(self._stacked(batch))
                graph_mask = self._gathered(batch.graph_mask.to(torch.uint8)).bool()
            if prefer_fused:
                if not hasattr(batch, "adj") and not self._warned_unfusable:
                    warnings.warn(
                        "predict(prefer_fused=True) got a COO-layout batch; "
                        "using the unfused path (build the loader with "
                        "layout='dense' for fused serving)",
                        UserWarning,
                        stacklevel=3,  # past the inference_mode wrapper
                    )
                    self._warned_unfusable = True
                logits = forward_auto(model, batch)
            else:
                logits = model(batch)
            # real-graph mask, not label_mask: unlabeled graphs still get
            # predictions
            if graph_mask is not None:
                chunks.append(self._gathered(logits)[graph_mask])
            else:
                chunks.append(logits[batch.graph_mask])
        return torch.cat(chunks).cpu().numpy()

    def _gathered(self, t: torch.Tensor) -> torch.Tensor:
        """A merged batch's per-graph rows from every rank, in shard order."""
        S = self.mesh.local_shards
        return self.mesh.all_gather(t.reshape(S, -1, *t.shape[1:])).flatten(0, 1)

    # ------------------------------------------------------------------
    # Preemption-safe fit checkpoints
    # ------------------------------------------------------------------

    def _fit_ckpt_path(self, directory: str) -> str:
        """One file a rank: the ranks hold different dropout generators."""
        if self.mesh is not None and self.mesh.world > 1:
            return os.path.join(directory, f"fit_state.rank{self.mesh.rank}.npz")
        return os.path.join(directory, "fit_state.npz")

    def _save_fit_checkpoint(self, directory, epoch, best_epoch, best_val_loss, best, history,
                             stopped_early) -> None:
        """One atomic file: tensors AND bookkeeping, so state and meta can
        never come from different epochs."""
        opt = self.optimizer.state_dict()
        meta = {
            "epoch": epoch,
            "best_epoch": best_epoch,
            "best_val_loss": best_val_loss,
            "history": history,
            "stopped_early": stopped_early,
            "param_groups": opt["param_groups"],
        }
        save_checkpoint(self._fit_ckpt_path(directory), {
            "model": self.model.state_dict(),
            "best": best if best is not None else self.model.state_dict(),
            "optimizer": opt["state"],
            "generator": self.generator.get_state(),
            "shard_generators": [g.get_state() for g in self.shard_generators or []],
            "meta": np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        })

    def _restore_fit_checkpoint(self, directory) -> Optional[dict]:
        """Restore the fit state from ``directory``; returns the meta dict,
        or ``None`` when there is no checkpoint (a fresh start)."""
        path = self._fit_ckpt_path(directory)
        if not os.path.exists(path):
            return None
        weights = self.model.state_dict()
        tree = restore_checkpoint(path, {
            "model": weights, "best": weights, "generator": self.generator.get_state(),
            "shard_generators": [g.get_state() for g in self.shard_generators or []],
            "meta": 0,  # shape-free leaf: restored as stored
        })
        meta = json.loads(np.asarray(tree["meta"]).tobytes().decode())
        # the optimizer's state appears at its first step, so its structure
        # is read from the file rather than from a template
        state: dict = {}
        for key, value in load_arrays(path).items():
            if key.startswith("optimizer/"):
                _, index, name = key.split("/")
                state.setdefault(int(index), {})[name] = torch.from_numpy(value)
        self.optimizer.load_state_dict({"state": state, "param_groups": meta.pop("param_groups")})
        self._captured.clear()  # captured steps address the replaced optimizer state
        self.model.load_state_dict(tree["model"])
        self.generator.set_state(tree["generator"].cpu())
        for g, state in zip(self.shard_generators or [], tree["shard_generators"]):
            g.set_state(state.cpu())
        self._best = tree["best"]
        return meta
