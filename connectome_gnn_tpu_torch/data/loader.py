"""Batch loader with fixed batch shapes.

Mirrors ``connectome_gnn_tpu.data.loader.ConnectomeDataLoader``: every
batch has the same graph-slot count and padding budgets, the final partial
batch is padded with empty graph slots (masked via ``label_mask``), and
epoch ``t`` shuffles with ``numpy.random.default_rng(seed + t)`` — the same
stream as the JAX package, so both see the same batch order.

With ``num_shards`` each batch is split into that many equal shards, each
collated on its own with the same static shapes and stacked into a leading
shard axis (data parallelism, ``parallel/data_parallel.py``); with
``process_index`` / ``process_count`` a process collates only its
contiguous part of the shards, and every process shuffles the same way.
"""

from __future__ import annotations

import math
from typing import Iterator, Optional, Sequence

import numpy as np

from connectome_gnn_tpu_torch.data.batch import collate_graphs, round_up
from connectome_gnn_tpu_torch.data.dense import collate_dense
from connectome_gnn_tpu_torch.data.graph import ConnectomeGraph


class ConnectomeDataLoader:
    """Packs ``ConnectomeGraph`` objects into padded fixed-shape batches on
    ``device``.

    Parameters
    ----------
    dataset
        Sequence of host-side graphs.
    batch_size
        Graph slots per batch (every batch, including the last).
    shuffle
        Reshuffle indices each epoch.
    seed
        Base shuffle seed; epoch ``t`` uses ``seed + t``.
    node_budget / edge_budget
        Static per-batch padding budgets for the COO layout.  Default: the
        worst-case batch (sum of the ``batch_size`` largest graphs),
        rounded to the multiples.
    drop_last
        Drop the final partial batch instead of padding it.
    layout
        ``"coo"`` yields :class:`ConnectomeBatch`; ``"dense"`` yields
        :class:`DenseConnectomeBatch`.
    device
        Where the batches' tensors are placed (default: the CPU).
    num_shards
        Data-parallel shards: every batch is ``num_shards`` batches of
        ``batch_size / num_shards`` graph slots (each padded to the same
        budgets, the defaults then the worst shard's), stacked leaf-wise
        (``[num_shards, ...]``).
    process_index / process_count
        Given together (with ``num_shards``): this process collates only
        its shards ``[i·k, (i+1)·k)``, ``k = num_shards / process_count``.
    """

    def __init__(
        self,
        dataset: Sequence[ConnectomeGraph],
        batch_size: int = 16,
        shuffle: bool = True,
        seed: int = 0,
        node_budget: Optional[int] = None,
        edge_budget: Optional[int] = None,
        node_multiple: int = 8,
        edge_multiple: int = 128,
        drop_last: bool = False,
        num_shards: Optional[int] = None,
        layout: str = "coo",
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
        device=None,
    ):
        if len(dataset) == 0:
            raise ValueError("dataset is empty")
        if layout not in ("coo", "dense"):
            raise ValueError(f"unknown layout {layout!r}; expected 'coo' or 'dense'")
        self.layout = layout
        self.dataset = list(dataset)
        self.batch_size = int(batch_size)
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        self.drop_last = bool(drop_last)
        self.device = device
        self.num_shards = int(num_shards) if num_shards is not None else None
        self._epoch = 0

        if self.num_shards is not None and self.batch_size % self.num_shards:
            raise ValueError(
                f"batch_size={self.batch_size} not divisible by num_shards={self.num_shards}"
            )
        self._shard_size = (
            self.batch_size // self.num_shards if self.num_shards is not None else self.batch_size
        )
        if (process_index is None) != (process_count is None):
            raise ValueError("process_index and process_count must be given together")
        if process_count is not None:
            if self.num_shards is None:
                raise ValueError("process sharding requires num_shards")
            if self.num_shards % process_count:
                raise ValueError(
                    f"num_shards={self.num_shards} not divisible by process_count={process_count}"
                )
            if not 0 <= process_index < process_count:
                raise ValueError(
                    f"process_index={process_index} out of range [0, {process_count})"
                )
            per = self.num_shards // process_count
            self._shard_lo, self._shard_hi = process_index * per, (process_index + 1) * per
        else:
            self._shard_lo, self._shard_hi = 0, self.num_shards or 0

        if node_budget is None or edge_budget is None:
            nodes = sorted((g.num_nodes for g in self.dataset), reverse=True)
            edges = sorted((g.num_edges for g in self.dataset), reverse=True)
            k = min(self._shard_size, len(self.dataset))
            if node_budget is None:
                node_budget = round_up(sum(nodes[:k]), node_multiple)
            if edge_budget is None:
                edge_budget = round_up(sum(edges[:k]), edge_multiple)
        self.node_budget = int(node_budget)
        self.edge_budget = int(edge_budget)
        self._num_features = self.dataset[0].num_features
        # dense layout: one shared per-graph node budget
        self._dense_node_budget = round_up(
            max(g.num_nodes for g in self.dataset), node_multiple
        )

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return math.ceil(n / self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle stream: the next iteration uses ``seed + epoch``."""
        self._epoch = int(epoch)

    def __iter__(self) -> Iterator:
        indices = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(indices)
            self._epoch += 1
        for start in range(0, len(indices), self.batch_size):
            chunk = indices[start : start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                break
            if self.num_shards is None:
                yield self._collate([self.dataset[i] for i in chunk])
                continue
            from connectome_gnn_tpu_torch.parallel.data_parallel import stack_batches

            k = self._shard_size
            yield stack_batches([
                self._collate([self.dataset[i] for i in chunk[s * k : (s + 1) * k]])
                for s in range(self._shard_lo, self._shard_hi)
            ])

    def _collate(self, graphs: list):
        if self.layout == "dense":
            return collate_dense(
                graphs,
                num_graphs=self._shard_size,
                node_budget=self._dense_node_budget,
                num_features=self._num_features,
                device=self.device,
            )
        return collate_graphs(
            graphs,
            num_graphs=self._shard_size,
            node_budget=self.node_budget,
            edge_budget=self.edge_budget,
            num_features=self._num_features,
            device=self.device,
        )
