"""Sampled-minibatch giant-graph training: batches, collate, loader.

The port of ``connectome_gnn_tpu/data/sampled.py``, the path of BASELINE
config 5's "giant connectome with neighbor sampling".  Each step takes a
GraphSAGE-style fanout sample around a minibatch of seed nodes
(:class:`~connectome_gnn_tpu_torch.data.sampling.NeighborSampler`, the
native traversal) and packs it into a static-shape
:class:`SampledNodeBatch`: the node and edge budgets are the fanout
tree's worst case, so every step has the same shapes.  Supervision is on
the seeds only: the sampler puts them first and the models' head reads the
first ``num_seeds`` rows.

:class:`SampledNodeBatch` has the ``labels`` / ``label_mask`` /
``graph_mask`` surface of :class:`~connectome_gnn_tpu_torch.data.batch.
ConnectomeBatch`, so :class:`~connectome_gnn_tpu_torch.train.Trainer`
trains, evaluates and serves it unchanged with a model that returns
per-seed logits (:class:`~connectome_gnn_tpu_torch.models.node_coo.NodeGCN`,
``NodeSAGE``).

Index tensors are ``int64`` (torch's index type, as in ``ConnectomeBatch``);
their values equal the JAX package's ``int32`` arrays.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator, NamedTuple, Optional, Sequence

import numpy as np
import torch

from connectome_gnn_tpu_torch import native
from connectome_gnn_tpu_torch.data.batch import _to, card_by_default, round_up
from connectome_gnn_tpu_torch.data.graph import ConnectomeGraph
from connectome_gnn_tpu_torch.data.sampling import NeighborSampler


class HopBlock(NamedTuple):
    """One hop's edges in the device sampler's ``[frontier, fanout]`` layout.

    Row b holds frontier slot b's draws: ``senders[b, :]`` (local node ids;
    an invalid draw points at the receiver itself with weight 0), all
    received by local node ``recv[b]``.  Hop 0's ``recv`` is
    ``arange(num_seeds)``.

    In the multiset mode (``device_sample(..., dedup=False)``) locals are
    arithmetic: the senders are their own draw slots
    (``sender_start + arange(Fb * f)``) and the receivers the frontier's
    slots (``recv_start + arange(Fb)``), so the blocked layers take both
    as contiguous slices.  ``None`` in the dedup mode.
    """

    senders: torch.Tensor  # int64 [Fb, f]
    weights: torch.Tensor  # float32 [Fb, f]
    recv: torch.Tensor  # int64 [Fb]
    sender_start: Optional[int] = None
    recv_start: Optional[int] = None

    def to(self, device) -> "HopBlock":
        return self._replace(senders=self.senders.to(device), weights=self.weights.to(device),
                             recv=self.recv.to(device))


@dataclasses.dataclass
class SampledNodeBatch:
    """A padded k-hop sampled subgraph with seed-node supervision.

    Nodes are relabelled sampler-locally with the ``num_seeds`` seed slots
    first; edges are receiver-sorted (padding edges carry weight 0 and
    point at the last node slot, which keeps them inert and the sort
    valid).

    Attributes
    ----------
    node_features : float32 [N_budget, F]
    senders / receivers : int64 [E_budget]
    edge_weight : float32 [E_budget]   0 on padding
    node_mask : bool [N_budget]        real sampled nodes
    labels : int64 [S]                 per-seed labels (0 where unlabelled)
    label_mask : bool [S]              real and labelled seed slots
    seed_mask : bool [S]               real seed slots
    node_ids : int64 [N_budget]        the giant graph's id per slot (-1 padding)
    num_seeds : int
    hop_blocks : tuple of :class:`HopBlock` or None
        The device sampler's per-hop ``[frontier, fanout]`` views of the same
        edges, for the blocked layers; ``None`` for host-built batches.
    shard_regions : tuple of int or None
        Set on a rank's shards merged into one batch (``parallel.
        data_parallel.merge_sampled``): each shard's node regions, which the
        merge laid out region by region; the models' dropout draws each
        shard's mask in the shard's own layout through it.
    """

    node_features: torch.Tensor
    senders: torch.Tensor
    receivers: torch.Tensor
    edge_weight: torch.Tensor
    node_mask: torch.Tensor
    labels: torch.Tensor
    label_mask: torch.Tensor
    seed_mask: torch.Tensor
    node_ids: torch.Tensor
    num_seeds: int = 0
    hop_blocks: Optional[tuple] = None
    shard_regions: Optional[tuple] = None

    @property
    def num_nodes(self) -> int:
        return int(self.node_features.shape[0])

    @property
    def graph_mask(self) -> torch.Tensor:
        """Real seed slots: ``Trainer.predict`` serves unlabelled seeds too
        (``ConnectomeBatch.graph_mask``'s role)."""
        return self.seed_mask

    def to(self, device) -> "SampledNodeBatch":
        moved = _to(self, device)
        if self.hop_blocks is not None:
            moved.hop_blocks = tuple(b.to(device) for b in self.hop_blocks)
        return moved


def collate_sampled(
    subgraph: ConnectomeGraph,
    node_ids: np.ndarray,
    seed_labels: Optional[np.ndarray],
    *,
    num_seeds: int,
    real_seeds: int,
    node_budget: int,
    edge_budget: int,
    device=None,
) -> SampledNodeBatch:
    """Pack one sampled subgraph (seeds first, as the samplers return it)
    into a :class:`SampledNodeBatch` on ``device`` (default: ``cuda``;
    ``device="cpu"`` for the CPU).

    ``seed_labels`` are the labels of the real seeds (length
    ``real_seeds``); the remaining seed slots are masked padding.
    """
    device = card_by_default(device, "collate_sampled")
    n, e = subgraph.num_nodes, subgraph.num_edges
    if n > node_budget:
        raise ValueError(f"sampled {n} nodes > node_budget {node_budget}")
    if e > edge_budget:
        raise ValueError(f"sampled {e} edges > edge_budget {edge_budget}")
    if real_seeds > num_seeds:
        raise ValueError(f"{real_seeds} seeds > seed slots {num_seeds}")

    x = np.zeros((node_budget, subgraph.num_features), np.float32)
    x[:n] = subgraph.node_features
    node_mask = np.zeros(node_budget, bool)
    node_mask[:n] = True
    ids = np.full(node_budget, -1, np.int64)
    ids[:n] = node_ids

    # receiver-sorted; padding edges go to the last slot with weight 0
    src, dst = subgraph.edge_index
    order = np.argsort(dst, kind="stable")
    senders = np.full(edge_budget, node_budget - 1, np.int64)
    receivers = np.full(edge_budget, node_budget - 1, np.int64)
    weights = np.zeros(edge_budget, np.float32)
    senders[:e] = src[order]
    receivers[:e] = dst[order]
    weights[:e] = subgraph.edge_weight[order]

    labels = np.zeros(num_seeds, np.int64)
    label_mask = np.zeros(num_seeds, bool)
    seed_mask = np.zeros(num_seeds, bool)
    seed_mask[:real_seeds] = True
    if seed_labels is not None:
        labels[:real_seeds] = np.asarray(seed_labels, np.int64)
        label_mask[:real_seeds] = True

    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return SampledNodeBatch(
        node_features=t(x), senders=t(senders), receivers=t(receivers), edge_weight=t(weights),
        node_mask=t(node_mask), labels=t(labels), label_mask=t(label_mask),
        seed_mask=t(seed_mask), node_ids=t(ids), num_seeds=int(num_seeds),
    )


def _build_sampled_batch(
    feat_tab: torch.Tensor,
    ints: torch.Tensor,
    weights: torch.Tensor,
    *,
    node_budget: int,
    edge_budget: int,
    num_seeds: int,
    labeled: bool,
) -> SampledNodeBatch:
    """Unpack the one-transfer ingest buffers into a batch, on their device.

    ``ints`` (int32) is ``[n_nodes, real_seeds, node_ids(node_budget),
    senders(edge_budget), receivers(edge_budget), labels(num_seeds)]``,
    which the fused native collate writes in place, and ``weights``
    (float32) the edge weights: two copies to the card a step.  The node
    features are gathered here from the feature table uploaded once;
    padding ids (-1) read row 0 and are zeroed by the mask, which matches
    the host collate's zero fill bitwise.  Nothing is read back.
    """
    o = 2
    ids = ints[o : o + node_budget].long()
    o += node_budget
    senders = ints[o : o + edge_budget].long()
    o += edge_budget
    receivers = ints[o : o + edge_budget].long()
    o += edge_budget
    labels = ints[o : o + num_seeds].long()

    arange = lambda k: torch.arange(k, device=ints.device)  # noqa: E731
    node_mask = arange(node_budget) < ints[0]
    x = torch.where(node_mask[:, None], feat_tab[ids.clamp(0, feat_tab.shape[0] - 1)], 0.0)
    seed_mask = arange(num_seeds) < ints[1]
    label_mask = seed_mask if labeled else torch.zeros_like(seed_mask)
    return SampledNodeBatch(
        node_features=x, senders=senders, receivers=receivers, edge_weight=weights,
        node_mask=node_mask, labels=torch.where(label_mask, labels, 0), label_mask=label_mask,
        seed_mask=seed_mask, node_ids=ids, num_seeds=int(num_seeds),
    )


def full_graph_batch(
    graph: ConnectomeGraph,
    node_labels: Optional[np.ndarray] = None,
    *,
    seed_nodes: Optional[Sequence[int]] = None,
    node_multiple: int = 8,
    edge_multiple: int = 128,
    device=None,
) -> SampledNodeBatch:
    """The whole graph as one :class:`SampledNodeBatch` (the identity
    sample), on ``device`` (default: ``cuda``).

    The full-batch oracle of sampled training: every node is present and
    ``seed_nodes`` (default: all) are the supervised slots.  The node space
    is reordered seeds first, as the container's contract asks.
    """
    n = graph.num_nodes
    seeds = (
        np.arange(n, dtype=np.int64)
        if seed_nodes is None
        else np.asarray(list(dict.fromkeys(int(s) for s in seed_nodes)), np.int64)
    )
    rest = np.setdiff1d(np.arange(n, dtype=np.int64), seeds, assume_unique=False)
    order = np.concatenate([seeds, rest])  # order[new] = old
    relabel = np.empty(n, np.int64)
    relabel[order] = np.arange(n)

    src, dst = graph.edge_index
    reordered = ConnectomeGraph(
        node_features=graph.node_features[order],
        edge_index=np.stack([relabel[src], relabel[dst]]).astype(np.int32),
        edge_weight=graph.edge_weight,
        label=graph.label,
        subject_id=graph.subject_id,
    )
    labels = np.asarray(node_labels)[seeds] if node_labels is not None else None
    return collate_sampled(
        reordered, node_ids=order, seed_labels=labels,
        num_seeds=len(seeds), real_seeds=len(seeds),
        node_budget=round_up(n, node_multiple),
        edge_budget=round_up(graph.num_edges, edge_multiple),
        device=card_by_default(device, "full_graph_batch"),
    )


def fanout_budgets(batch_size: int, fanout: Sequence[int], num_features: int = 0) -> tuple[int, int]:
    """Worst-case ``(node, edge)`` budgets of a ``batch_size``-seed sample:
    every hop expands fully and nothing deduplicates."""
    nodes = batch_size
    edges = 0
    frontier = batch_size
    for f in fanout:
        frontier *= f
        edges += frontier
        nodes += frontier
    return nodes, edges


def _sample_seed(base: int, epoch: int, step: int, shard: int = -1) -> int:
    """The sampling seed of one (epoch, step, shard), platform-stable
    (``np.random.SeedSequence``, not ``hash()``), and decorrelated across
    epochs, steps and shards."""
    return int(
        np.random.SeedSequence([base, epoch, step, shard + 1]).generate_state(1)[0] & 0x7FFFFFFF
    )


def epoch_seeds(seeds: np.ndarray, shuffle: bool, seed: int, epoch: int) -> np.ndarray:
    """The seed pool in epoch ``epoch``'s order: shuffled by
    ``default_rng(seed + epoch)`` when ``shuffle``."""
    if shuffle:
        return seeds[np.random.default_rng(seed + epoch).permutation(len(seeds))]
    return seeds


class SampledNodeLoader:
    """Per-step neighbor-sampled minibatches over one giant graph.

    Each pass shuffles the seed pool, chunks it into ``batch_size`` seed
    minibatches, fanout-samples each (the native traversal, the index built
    once) and yields static-shape :class:`SampledNodeBatch` es on
    ``device``.  Drives :class:`~connectome_gnn_tpu_torch.train.Trainer`.

    Parameters
    ----------
    graph
        The giant host-side graph.
    node_labels
        Integer label per node, or None (unlabelled serving).
    seed_nodes
        The supervised node pool (default: every node).
    batch_size
        Seed nodes per step (the static seed-slot count).
    fanout
        In-neighbor cap per hop; its length is the depth and should be the
        model's ``num_layers``.
    node_budget / edge_budget
        Static paddings; default the no-dedup worst case
        (:func:`fanout_budgets`) capped at the whole graph.
    shuffle / seed
        The pool's shuffle, pinned per epoch (``set_epoch`` replays a
        resumed run).  The per-step sampling streams advance with the
        epoch even with ``shuffle=False``.
    drop_last
        Drop the final partial seed chunk instead of padding it.
    fused
        The fused native sample-and-collate (default: where the native
        library is available): one traversal writes the padded arrays into
        one int32 buffer, which crosses to the device with one float32
        buffer of weights; the features are gathered there from a table
        uploaded once.  The same subgraphs as the classic path
        (``NeighborSampler.sample`` + :func:`collate_sampled`); only the
        edge order within a receiver differs.
    device
        Where the batches are made (default ``cuda``; without a card that
        raises ``RuntimeError``, and ``device="cpu"`` asks for the CPU).
    num_shards
        When set, ``batch_size`` is the global seed count a step and each
        batch is stacked: a leading shard axis of ``num_shards`` per-shard
        batches of ``batch_size / num_shards`` seeds, each sampled on its
        own (``Trainer(mesh=...)`` runs them data-parallel).  The budgets
        are a shard's.  The final partial batch pads its trailing shards.
    process_index / process_count
        With both set, each batch stacks only this process's contiguous
        ``num_shards / process_count`` shards.  The shuffle and each shard's
        sampling stream are functions of the global shard index, so a batch
        is the same however its shards are spread over processes.
    """

    def __init__(
        self,
        graph: ConnectomeGraph,
        node_labels: Optional[np.ndarray] = None,
        *,
        seed_nodes: Optional[Sequence[int]] = None,
        batch_size: int = 512,
        fanout: Sequence[int] = (10, 10),
        node_budget: Optional[int] = None,
        edge_budget: Optional[int] = None,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
        node_multiple: int = 8,
        edge_multiple: int = 128,
        num_shards: Optional[int] = None,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
        fused: Optional[bool] = None,
        device=None,
    ):
        self.device = torch.device(card_by_default(device, "SampledNodeLoader"))
        self.graph = graph
        self.node_labels = np.asarray(node_labels, np.int32) if node_labels is not None else None
        self.seeds = (
            np.arange(graph.num_nodes, dtype=np.int64)
            if seed_nodes is None
            else np.asarray(seed_nodes, np.int64)
        )
        self.batch_size = int(batch_size)
        self.fanout = tuple(int(f) for f in fanout)
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        self.drop_last = bool(drop_last)
        self._epoch = 0
        self._sampler = NeighborSampler(graph)
        self.num_shards, self._shard_size, self._shard_lo, self._shard_hi = shard_layout(
            self.batch_size, num_shards, process_index, process_count)

        worst_n, worst_e = fanout_budgets(self._shard_size, self.fanout)
        if node_budget is None:
            node_budget = min(worst_n, graph.num_nodes)
        if edge_budget is None:
            edge_budget = min(worst_e, graph.num_edges)
        self.node_budget = round_up(int(node_budget), node_multiple)
        self.edge_budget = round_up(int(edge_budget), edge_multiple)

        self.fused = bool(native.AVAILABLE) if fused is None else bool(fused)
        if self.fused and not native.AVAILABLE:
            raise RuntimeError("fused=True requires the native library")
        # the fused path's feature table, on the device once
        self._feat_tab = (
            torch.as_tensor(graph.node_features, dtype=torch.float32, device=self.device)
            if self.fused
            else None
        )

    def __len__(self) -> int:
        n = len(self.seeds)
        if self.drop_last:
            return n // self.batch_size
        return math.ceil(n / self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle and the per-step sampling streams to ``epoch``."""
        self._epoch = int(epoch)

    def _sample_and_collate_fused(self, chunk: np.ndarray, sample_seed: int,
                                  S: int) -> SampledNodeBatch:
        """One native traversal into the ingest buffers, then the unpack
        and the feature gather on the device (:func:`_build_sampled_batch`).
        An empty chunk (a padded shard of the final batch) is all padding."""
        nb, eb = self.node_budget, self.edge_budget
        ints = np.empty(2 + nb + 2 * eb + S, np.int32)
        weights = np.empty(eb, np.float32)
        ids = ints[2 : 2 + nb]
        senders = ints[2 + nb : 2 + nb + eb]
        receivers = ints[2 + nb + eb : 2 + nb + 2 * eb]
        labels = ints[2 + nb + 2 * eb :]
        if len(chunk) == 0:
            n_nodes = 0
            ids.fill(-1)
            senders.fill(nb - 1)
            receivers.fill(nb - 1)
            weights.fill(0.0)
        else:
            n_nodes, _ = self._sampler.sample_collate_into(
                chunk, self.fanout, sample_seed,
                node_budget=nb, edge_budget=eb,
                out_senders=senders, out_receivers=receivers,
                out_weights=weights, out_node_ids=ids,
            )
        ints[0] = n_nodes
        ints[1] = len(chunk)
        labels.fill(0)
        if self.node_labels is not None:
            labels[: len(chunk)] = self.node_labels[chunk]
        return _build_sampled_batch(
            self._feat_tab, torch.from_numpy(ints).to(self.device),
            torch.from_numpy(weights).to(self.device),
            node_budget=nb, edge_budget=eb, num_seeds=S, labeled=self.node_labels is not None,
        )

    def _sample_and_collate(self, chunk: np.ndarray, sample_seed: int, S: int) -> SampledNodeBatch:
        if self.fused:
            return self._sample_and_collate_fused(chunk, sample_seed, S)
        if len(chunk) == 0:
            # a padded shard of the final batch: all padding
            sub = ConnectomeGraph(node_features=np.zeros((0, self.graph.num_features), np.float32),
                                  edge_index=np.zeros((2, 0), np.int32),
                                  edge_weight=np.zeros(0, np.float32))
            node_ids = np.zeros(0, np.int64)
        else:
            sub, node_ids = self._sampler.sample(chunk, self.fanout, seed=sample_seed)
        return collate_sampled(
            sub, node_ids,
            self.node_labels[chunk] if self.node_labels is not None else None,
            num_seeds=S, real_seeds=len(chunk),
            node_budget=self.node_budget, edge_budget=self.edge_budget, device=self.device,
        )

    def __iter__(self) -> Iterator[SampledNodeBatch]:
        epoch = self._epoch
        # advance whether or not it shuffles, so repeated passes draw
        # fresh subgraphs
        self._epoch += 1
        seeds = epoch_seeds(self.seeds, self.shuffle, self.seed, epoch)
        for b, start in enumerate(range(0, len(seeds), self.batch_size)):
            chunk = seeds[start : start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                break
            if self.num_shards is None:
                yield self._sample_and_collate(chunk, _sample_seed(self.seed, epoch, b),
                                               self.batch_size)
                continue
            from connectome_gnn_tpu_torch.parallel.data_parallel import stack_batches

            ss = self._shard_size
            yield stack_batches([
                self._sample_and_collate(chunk[s * ss : (s + 1) * ss],
                                         _sample_seed(self.seed, epoch, b, s), ss)
                for s in range(self._shard_lo, self._shard_hi)
            ])


def shard_layout(batch_size: int, num_shards, process_index, process_count):
    """``(num_shards, seeds a shard, lo, hi)`` of a sharded loader: the
    process's shards are ``[lo, hi)`` (all of them without a process
    count); ``num_shards`` None means unsharded."""
    if (process_index is None) != (process_count is None):
        raise ValueError("process_index and process_count must be given together")
    if num_shards is None:
        if process_count is not None:
            raise ValueError("process sharding requires num_shards")
        return None, batch_size, 0, 0
    D = int(num_shards)
    if batch_size % D:
        raise ValueError(f"batch_size={batch_size} not divisible by num_shards={D}")
    if process_count is None:
        return D, batch_size // D, 0, D
    if D % process_count:
        raise ValueError(f"num_shards={D} not divisible by process_count={process_count}")
    if not 0 <= process_index < process_count:
        raise ValueError(f"process_index={process_index} out of range [0, {process_count})")
    per = D // process_count
    return D, batch_size // D, process_index * per, (process_index + 1) * per
