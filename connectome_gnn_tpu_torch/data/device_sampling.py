"""Device-side neighbor sampling: the giant graph lives on the card and
every step's fanout sample is drawn there.

The port of ``connectome_gnn_tpu/data/device_sampling.py``.  The CSR
adjacency, the features and the weights are uploaded once
(:class:`DeviceGraphCSR`: indptr 4 MB, packed (sender, weight) pairs 352 MB
and features 20 MB at 1M nodes, 44M edges and 5 features), and each
training step receives one int32 row of ~8 KB (:class:`SeedBatch`: the
seeds, a sampling key and the labels).  Sampling, dedup, relabelling, the
feature gather and the train step then run on the device from static
shapes, with nothing read back; :class:`~connectome_gnn_tpu_torch.train.
Trainer` with ``scan_epochs=True`` replays one captured CUDA graph a step
from one buffer uploaded an epoch.

Sampling semantics are the host samplers': hop expansion over in-edges, up
to ``fanout[h]`` in-neighbors per frontier node, uniform without
replacement (the top f of iid uniforms over a node's edge slots), seeds
first.  :func:`device_sample` takes a sample in two steps: the draws
(:func:`hop_draws`, a counter-based integer hash of the row's key, the hop
and the slot, in torch integer ops, so bitwise the same on the CPU and the
card and replayable inside a captured graph), then the sample given those
draws, which a caller may pass instead (the tests pass ``jax.random``'s, and
the sample is then bitwise the JAX package's).  The draws differ from
``jax.random``'s stream, so the port's samples equal JAX's in distribution,
not bitwise; with ``fanout >= max_in_degree`` every in-edge is kept and the
model outputs agree (the keep-all oracle).

Data parallelism: a sharded :class:`DeviceSeedLoader` (``num_shards``,
``process_index`` / ``process_count``) yields stacked seed rows ``[D_local,
3 + 2S]``, each with its own key, and :func:`pack_epoch_sharded` packs an
epoch of them; ``parallel/sampled_dp.py`` samples every local row against
one CSR replicated to the mesh's device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence

import numpy as np
import torch
from torch import nn

from connectome_gnn_tpu_torch.data.batch import card_by_default
from connectome_gnn_tpu_torch.data.graph import ConnectomeGraph
from connectome_gnn_tpu_torch.data.sampled import (
    HopBlock,
    SampledNodeBatch,
    _sample_seed,
    epoch_seeds,
    fanout_budgets,
    shard_layout,
)

FEATURE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}
_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def cap_in_degree_mask(dst: np.ndarray, w: np.ndarray, cap: int) -> np.ndarray:
    """Boolean keep-mask (original edge order) keeping, per receiver, the
    ``cap`` largest-``|weight|`` in-edges; ties go to the earliest edge in
    the stable receiver order.

    Every draw buffer is sized by the global ``max_in_degree``, so one hub
    prices the whole buffer; capping keeps the strongest connections and
    bounds the buffers at ``cap``.
    """
    cap = int(cap)
    if cap < 1:
        raise ValueError(f"in_degree_cap must be >= 1, got {cap}")
    E = int(len(dst))
    if E == 0:
        return np.ones(0, bool)
    order = np.argsort(dst, kind="stable")  # the stable receiver sort
    absw = np.abs(np.asarray(w, np.float32)[order])
    pos = np.arange(E)
    o2 = np.lexsort((pos, -absw, dst[order]))  # dst, |w| descending, position
    dst2 = dst[order][o2]
    rank = np.arange(E) - np.searchsorted(dst2, dst2, side="left")
    keep = np.ones(E, bool)
    keep[order[o2[rank >= cap]]] = False
    return keep


@dataclasses.dataclass
class DeviceGraphCSR:
    """Receiver-grouped CSR adjacency resident on a device.

    The adjacency is either packed ``sender_weight`` ``[E, 2]`` int32 rows of
    (sender id, the float32 weight's bits), the default (one 8-byte random
    access a draw instead of two 4-byte ones), or flat ``senders`` /
    ``edge_weight`` (``from_graph(packed=False)``), never both.
    ``max_in_degree`` sizes the per-node draw buffer.  Not a module buffer:
    a model's ``to()`` does not move it, and checkpoints leave it out.
    """

    indptr: torch.Tensor  # int32 [N + 1]
    node_features: torch.Tensor  # float32 / bfloat16 / int8 [N, F]
    senders: Optional[torch.Tensor] = None  # int32 [E], grouped by receiver
    edge_weight: Optional[torch.Tensor] = None  # float32 [E]
    sender_weight: Optional[torch.Tensor] = None  # int32 [E, 2] packed
    feature_scale: Optional[torch.Tensor] = None  # float32 [F], int8 tables
    max_in_degree: int = 0

    @property
    def num_nodes(self) -> int:
        return int(self.indptr.shape[0]) - 1

    @property
    def num_edges(self) -> int:
        adjacency = self.senders if self.senders is not None else self.sender_weight
        return int(adjacency.shape[0])

    @property
    def device(self) -> torch.device:
        return self.indptr.device

    @property
    def nbytes(self) -> int:
        """Bytes of every array it holds."""
        return sum(t.numel() * t.element_size() for t in self._tensors().values())

    def _tensors(self) -> dict:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)}

    def gather_features(self, idx: torch.Tensor) -> torch.Tensor:
        """Rows ``idx`` of the feature table in float32 (int8 tables
        dequantized by their per-column scale)."""
        x = self.node_features[idx].float()
        if self.feature_scale is not None:
            return x * self.feature_scale
        return x

    def edges_of(self, eid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(sender int64, weight float32)`` of edges ``eid``."""
        if self.sender_weight is not None:
            sw = self.sender_weight[eid]  # [..., 2]: one pass over the pairs
            return sw[..., 0].long(), sw[..., 1].contiguous().view(torch.float32)
        return self.senders[eid].long(), self.edge_weight[eid]

    def to(self, device) -> "DeviceGraphCSR":
        return dataclasses.replace(self, **{k: t.to(device) for k, t in self._tensors().items()})

    @classmethod
    def from_graph(
        cls,
        graph: ConnectomeGraph,
        *,
        packed: bool = True,
        feature_dtype: str = "float32",
        in_degree_cap: Optional[int] = None,
        device=None,
    ) -> "DeviceGraphCSR":
        """One host pass (the receiver sort), then the upload to ``device``
        (default ``cuda``; ``device="cpu"`` for the CPU).

        ``feature_dtype``: ``"float32"``; ``"bfloat16"`` (rounded to
        nearest even, read back as float32); or ``"int8"``, symmetric per
        column, ``q = round(x / s)`` with ``s = absmax / 127`` (error at
        most ``s / 2``).  ``in_degree_cap`` keeps each node's ``cap``
        largest-``|weight|`` in-edges (:func:`cap_in_degree_mask`).
        """
        device = card_by_default(device, "DeviceGraphCSR.from_graph")
        if feature_dtype not in FEATURE_DTYPES:
            raise ValueError(f"feature_dtype must be float32/bfloat16/int8, got {feature_dtype!r}")
        src, dst = graph.edge_index
        ew = graph.edge_weight
        if in_degree_cap is not None:
            keep = cap_in_degree_mask(dst, ew, in_degree_cap)
            src, dst, ew = src[keep], dst[keep], ew[keep]
        order = np.argsort(dst, kind="stable")
        counts = np.bincount(dst[order], minlength=graph.num_nodes)
        indptr = np.zeros(graph.num_nodes + 1, np.int32)
        np.cumsum(counts, out=indptr[1:])
        snd = src[order].astype(np.int32)
        w = ew[order].astype(np.float32)
        t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
        adjacency = (
            dict(sender_weight=t(np.stack([snd, w.view(np.int32)], axis=1)))
            if packed
            else dict(senders=t(snd), edge_weight=t(w))
        )
        x = graph.node_features.astype(np.float32)
        scale = None
        if feature_dtype == "int8":
            s = np.abs(x).max(axis=0) / 127.0
            s = np.where(s > 0, s, 1.0).astype(np.float32)
            feats = t(np.clip(np.round(x / s), -127, 127).astype(np.int8))
            scale = t(s)
        else:
            feats = t(x).to(FEATURE_DTYPES[feature_dtype])
        return cls(
            indptr=t(indptr), node_features=feats, feature_scale=scale,
            max_in_degree=int(counts.max()) if counts.size else 0, **adjacency,
        )


@dataclasses.dataclass
class SeedBatch:
    """One device-sampled step's payload: one int32 row
    ``[real_seeds, key_hi, key_lo, seeds(S), labels(S)]`` (~8 KB).

    Seed slots past ``real_seeds`` hold -1.  It has the ``labels`` /
    ``label_mask`` / ``graph_mask`` surface :class:`~connectome_gnn_tpu_torch.
    train.Trainer` reads, so a :class:`DeviceSampledModel` trains through it
    unchanged.  ``csr`` (optional) names the graph to sample from; ``to()``
    moves the row and leaves the graph where it is.

    A stacked batch (a sharded :class:`DeviceSeedLoader`'s) carries rows
    ``[D_local, 3 + 2S]``, one a shard, each with its own key; every
    property then has the leading shard axis.
    """

    packed: torch.Tensor  # int32 [3 + 2 * num_seeds] (or [D_local, ...] stacked)
    csr: Optional[DeviceGraphCSR] = None
    num_seeds: int = 0
    labeled: bool = True

    @property
    def stacked(self) -> bool:
        return self.packed.dim() == 2

    @property
    def seeds(self) -> torch.Tensor:
        return self.packed[..., 3 : 3 + self.num_seeds].long()

    @property
    def key_words(self) -> torch.Tensor:
        """int64 ``[2]``: the key's two 32-bit words (hi, lo), unsigned."""
        return self.packed[..., 1:3].long() & _M32

    @property
    def seed_mask(self) -> torch.Tensor:
        return torch.arange(self.num_seeds, device=self.packed.device) < self.packed[..., 0:1]

    @property
    def label_mask(self) -> torch.Tensor:
        if not self.labeled:
            return torch.zeros_like(self.seed_mask)
        return self.seed_mask

    @property
    def labels(self) -> torch.Tensor:
        raw = self.packed[..., 3 + self.num_seeds : 3 + 2 * self.num_seeds].long()
        return torch.where(self.label_mask, raw, 0)

    @property
    def graph_mask(self) -> torch.Tensor:
        return self.seed_mask

    def to(self, device) -> "SeedBatch":
        return dataclasses.replace(self, packed=self.packed.to(device))


def _pack_seed_row(chunk: np.ndarray, labels: Optional[np.ndarray], sample_seed: int,
                   num_seeds: int) -> np.ndarray:
    packed = np.empty(3 + 2 * num_seeds, np.int32)
    packed[0] = len(chunk)
    packed[1:3] = np.array([0, sample_seed], np.uint32).view(np.int32)
    packed[3 : 3 + num_seeds] = -1
    packed[3 : 3 + len(chunk)] = chunk
    lab = packed[3 + num_seeds :]
    lab[:] = 0
    if labels is not None and len(chunk):
        lab[: len(chunk)] = labels[chunk]
    return packed


def make_seed_batch(
    chunk: np.ndarray,
    labels: Optional[np.ndarray],
    sample_seed: int,
    num_seeds: int,
    csr: Optional[DeviceGraphCSR] = None,
    device=None,
) -> SeedBatch:
    """A :class:`SeedBatch` on ``device`` (default: ``csr``'s device, else
    ``cuda``): numpy fills and one copy."""
    if device is None and csr is not None:
        device = csr.device
    device = card_by_default(device, "make_seed_batch")
    return SeedBatch(
        packed=torch.from_numpy(_pack_seed_row(chunk, labels, sample_seed, num_seeds)).to(device),
        csr=csr, num_seeds=int(num_seeds), labeled=labels is not None,
    )


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x · c mod 2^32`` for int64 ``x`` in ``[0, 2^32)`` without passing
    2^63: ``c``'s top bit contributes ``(x mod 2) · 2^31``."""
    out = x * (c & 0x7FFFFFFF)
    if c >> 31:
        out = out + ((x & 1) << 31)
    return out & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A bijective 32-bit integer hash (Wellons' ``lowbias32``) on int64
    values in ``[0, 2^32)``."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def hop_draws(key_words: torch.Tensor, hop: int, shape: tuple[int, int]) -> torch.Tensor:
    """Hop ``hop``'s uniform draws ``[Fb, max_deg]`` in ``[0, 1)`` (float32,
    24 bits), a function of the key, the hop and the slot alone.

    A counter-based integer hash in torch ops on ``key_words``' device: no
    generator state, so a captured graph replays it for each row's key, and
    the CPU and the card give the same bits.
    """
    hi, lo = key_words[0], key_words[1]
    stream = _mix32(_mix32(lo) ^ hi)
    stream = _mix32(stream ^ (((hop + 1) * _GOLDEN) & _M32))
    slots = torch.arange(shape[0] * shape[1], device=key_words.device)
    bits = _mix32(_mix32(slots ^ stream) ^ stream)
    return ((bits >> 8).float() * 2.0**-24).view(shape)


def _hop_sample(csr: DeviceGraphCSR, frontier: torch.Tensor, u: torch.Tensor, f: int):
    """The top ``f`` of a frontier's masked draws: ``(evalid [Fb, k],
    global senders, weights)``.  Ties go to the lower slot, as
    ``lax.top_k``'s do (a stable descending sort)."""
    E = csr.num_edges
    v = frontier.clamp(min=0)
    start = csr.indptr[v].long()
    deg = torch.where(frontier >= 0, csr.indptr[v + 1].long() - start, 0)
    slots = torch.arange(u.shape[1], device=u.device)
    scores = torch.where(slots[None, :] < deg[:, None], u, -1.0)
    k = min(f, u.shape[1])
    vals, pos = torch.sort(scores, dim=1, descending=True, stable=True)
    vals, pos = vals[:, :k], pos[:, :k]
    evalid = vals >= 0.0
    snd, w_raw = csr.edges_of((start[:, None] + pos).clamp(max=E - 1))
    return evalid, snd, torch.where(evalid, w_raw, 0.0)


def device_sample(
    csr: DeviceGraphCSR,
    seeds: torch.Tensor,
    key_words: Optional[torch.Tensor],
    fanout: Sequence[int],
    *,
    dedup: bool = True,
    draws: Optional[Sequence[torch.Tensor]] = None,
) -> SampledNodeBatch:
    """k-hop fanout sample on ``seeds``' device, with static shapes and no
    read back (labels unset: :class:`DeviceSampledModel` takes them from the
    :class:`SeedBatch`).

    ``seeds``: int64 ``[S]``, -1 on padding slots (they keep their local id,
    so the head still reads ``x[:S]``, with degree 0 and zero features).
    ``key_words``: the int64 ``[2]`` key of :func:`hop_draws`.  ``draws``:
    the per-hop uniforms ``[Fb, max_deg]`` in place of :func:`hop_draws`'
    (``max_deg = max(csr.max_in_degree, max(fanout), 1)``).

    ``dedup=False`` is the multiset (node-wise sampling tree) mode: every
    draw gets its own node slot, with no relabel table and no dedup sort.
    Re-encountered nodes sample their in-neighborhoods independently per
    occurrence and BatchNorm weights nodes by occurrences; with ``fanout >=
    max_in_degree`` eval-mode outputs equal the dedup mode's.
    """
    fanout = tuple(int(f) for f in fanout)
    max_deg = max(csr.max_in_degree, max(fanout) if fanout else 1, 1)
    if draws is None:
        draws, rows = [], int(seeds.shape[0])
        for h, f in enumerate(fanout):
            draws.append(hop_draws(key_words, h, (rows, max_deg)))
            rows *= f
    sample = _sample_dedup if dedup else _sample_multiset
    return sample(csr, seeds.long(), fanout, draws)


def _sample_dedup(csr, seeds, fanout, draws) -> SampledNodeBatch:
    """New nodes are appended a hop at a time in ascending global id; JAX's
    dropped writes (``mode="drop"``) land in one spare slot past the end of
    ``relabel`` and ``all_nodes``."""
    N = csr.num_nodes
    S = int(seeds.shape[0])
    node_budget, _ = fanout_budgets(S, fanout)
    dev = seeds.device
    arange = lambda k: torch.arange(k, device=dev)  # noqa: E731

    svalid = seeds >= 0
    relabel = torch.full((N + 1,), -1, dtype=torch.long, device=dev)
    relabel[torch.where(svalid, seeds, N)] = arange(S)
    all_nodes = torch.full((node_budget + 1,), -1, dtype=torch.long, device=dev)
    all_nodes[:S] = torch.where(svalid, seeds, -1)
    n_sofar = torch.full((), S, device=dev)

    frontier = torch.where(svalid, seeds, -1)  # global ids, -1 invalid
    frontier_local = arange(S)  # ascending, padding included
    senders, receivers, weights, blocks = [], [], [], []
    for h, f in enumerate(fanout):
        evalid, snd, w = _hop_sample(csr, frontier, draws[h], f)
        rloc = frontier_local[:, None].expand(evalid.shape).reshape(-1)
        evalid_flat = evalid.reshape(-1)
        cand = torch.where(evalid_flat, snd.reshape(-1), N)  # N: no draw
        L = cand.shape[0]

        # dedup within the hop and discover new nodes in ascending id; the
        # sort carries positions, so fresh locals scatter back to their
        # draws without a second table gather
        r_known = relabel[cand.clamp(max=N - 1)]
        known = torch.where(cand < N, r_known >= 0, True)
        fresh_sorted, order = torch.sort(torch.where(known, N, cand))
        first = (fresh_sorted < N) & torch.cat(
            [torch.ones(1, dtype=torch.bool, device=dev), fresh_sorted[1:] != fresh_sorted[:-1]])
        prefix = torch.cumsum(first.long(), 0)
        loc_new = n_sofar + prefix - 1  # one local for every duplicate
        if h + 1 < len(fanout):
            relabel[torch.where(first, fresh_sorted, N)] = loc_new
        all_nodes[torch.where(first, loc_new, node_budget)] = fresh_sorted
        base = n_sofar  # above every earlier receiver local
        n_sofar = n_sofar + prefix[-1]

        # senders: known ones from the table, fresh ones by position;
        # invalid draws become weight-0 self-edges on the receiver
        loc_at_pos = torch.zeros(L, dtype=torch.long, device=dev).scatter(
            0, order, torch.where(fresh_sorted < N, loc_new, 0))
        snd_final = torch.where(evalid_flat, torch.where(known, r_known, loc_at_pos), rloc)
        senders.append(snd_final)
        receivers.append(rloc)
        weights.append(w.reshape(-1))
        blocks.append(HopBlock(senders=snd_final.view(evalid.shape), weights=w, recv=frontier_local))

        # the next frontier: first occurrences, ascending; locals forward-
        # filled so the next hop's receivers stay sorted.  JAX's running
        # max of the first occurrences' locals is ``loc_new`` wherever one
        # has occurred (``prefix > 0``): ``loc_new`` grows with ``prefix``
        frontier = torch.where(first, fresh_sorted, -1)
        frontier_local = torch.where(prefix > 0, loc_new, base.clamp(max=node_budget - 1))
    return _batch(csr, all_nodes[:node_budget], S, senders, receivers, weights, blocks)


def _sample_multiset(csr, seeds, fanout, draws) -> SampledNodeBatch:
    """Node slots are [seeds, hop-1 draws, hop-2 draws, ...] in emission
    order: a draw's sender local is its own slot and its receiver local its
    frontier row's slot.  The only random accesses left are the degree
    lookup, the (sender, weight) fetch and the feature gather."""
    S = int(seeds.shape[0])
    dev = seeds.device
    frontier = torch.where(seeds >= 0, seeds, -1)
    frontier_start, offset = 0, S  # the frontier's first local; the next free slot
    nodes, senders, receivers, weights, blocks = [frontier], [], [], [], []
    for h, f in enumerate(fanout):
        Fb = int(frontier.shape[0])
        evalid, snd, w = _hop_sample(csr, frontier, draws[h], f)
        evalid_flat = evalid.reshape(-1)
        rloc_rows = frontier_start + torch.arange(Fb, device=dev)
        rloc = rloc_rows[:, None].expand(evalid.shape).reshape(-1)
        slots = offset + torch.arange(evalid.numel(), device=dev)
        snd_final = torch.where(evalid_flat, slots, rloc)  # invalid: weight-0 self-edges
        frontier = torch.where(evalid_flat, snd.reshape(-1), -1)
        nodes.append(frontier)
        senders.append(snd_final)
        receivers.append(rloc)
        weights.append(w.reshape(-1))
        blocks.append(HopBlock(senders=snd_final.view(evalid.shape), weights=w, recv=rloc_rows,
                               sender_start=offset, recv_start=frontier_start))
        frontier_start, offset = offset, offset + evalid.numel()
    return _batch(csr, torch.cat(nodes), S, senders, receivers, weights, blocks)


def _batch(csr, all_nodes, S, senders, receivers, weights, blocks) -> SampledNodeBatch:
    dev = all_nodes.device
    node_mask = all_nodes >= 0
    x = torch.where(node_mask[:, None], csr.gather_features(all_nodes.clamp(0, csr.num_nodes - 1)),
                    0.0)
    cat = lambda parts, dtype: torch.cat(parts) if parts else torch.zeros(0, dtype=dtype, device=dev)  # noqa: E731
    zeros = torch.zeros(S, dtype=torch.long, device=dev)
    return SampledNodeBatch(
        node_features=x, senders=cat(senders, torch.long), receivers=cat(receivers, torch.long),
        edge_weight=cat(weights, torch.float32), node_mask=node_mask, labels=zeros,
        label_mask=zeros.bool(), seed_mask=zeros.bool(), node_ids=all_nodes, num_seeds=S,
        hop_blocks=tuple(blocks) if blocks else None,
    )


class DeviceSeedLoader:
    """Per-step :class:`SeedBatch` producer for device-side sampling.

    :class:`~connectome_gnn_tpu_torch.data.sampled.SampledNodeLoader`'s
    epoch semantics (the shuffle pinned per epoch, per-(epoch, step)
    sampling streams that advance even with ``shuffle=False``, ``set_epoch``
    replay), but it yields only seed rows: the graph never leaves the
    device.  Host work a step: one slice of a permutation and one ~8 KB row.
    ``device`` defaults to ``csr``'s, else ``cuda`` (without a card that
    raises ``RuntimeError``; ``device="cpu"`` asks for the CPU).

    ``num_shards``: ``batch_size`` is the global seed count a step and each
    batch is a stacked :class:`SeedBatch` of ``[D_local, 3 + 2S]`` rows,
    ``S = batch_size / num_shards``, shard ``s`` of step ``b`` keyed
    ``_sample_seed(seed, epoch, b, s)`` by its global index; the final
    partial batch pads its trailing shards.  ``process_index`` /
    ``process_count`` keep only this process's contiguous shards, so a
    batch is the same however its shards are spread over processes.
    """

    def __init__(
        self,
        seed_pool,
        node_labels: Optional[np.ndarray] = None,
        *,
        batch_size: int = 512,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
        csr: Optional[DeviceGraphCSR] = None,
        num_shards: Optional[int] = None,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
        device=None,
    ):
        if device is None and csr is not None:
            device = csr.device
        self.device = torch.device(card_by_default(device, "DeviceSeedLoader"))
        self.csr = csr
        self.seeds = np.asarray(seed_pool, np.int64)
        self.node_labels = np.asarray(node_labels, np.int32) if node_labels is not None else None
        self.batch_size = int(batch_size)
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        self.drop_last = bool(drop_last)
        self._epoch = 0
        self.num_shards, self._shard_size, self._shard_lo, self._shard_hi = shard_layout(
            self.batch_size, num_shards, process_index, process_count)

    def __len__(self) -> int:
        n = len(self.seeds)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    @property
    def row_shape(self) -> tuple:
        """A batch's packed shape: ``(3 + 2S,)``, or ``(D_local, 3 + 2S)``
        sharded."""
        row = 3 + 2 * self._shard_size
        return (row,) if self.num_shards is None else (self._shard_hi - self._shard_lo, row)

    def rows(self) -> Iterator[np.ndarray]:
        """The next epoch's packed rows, one array a step (advances the
        epoch)."""
        epoch = self._epoch
        self._epoch += 1
        seeds = epoch_seeds(self.seeds, self.shuffle, self.seed, epoch)
        ss = self._shard_size
        for b, start in enumerate(range(0, len(seeds), self.batch_size)):
            chunk = seeds[start : start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                break
            if self.num_shards is None:
                yield _pack_seed_row(chunk, self.node_labels, _sample_seed(self.seed, epoch, b), ss)
            else:
                yield np.stack([
                    _pack_seed_row(chunk[s * ss : (s + 1) * ss], self.node_labels,
                                   _sample_seed(self.seed, epoch, b, s), ss)
                    for s in range(self._shard_lo, self._shard_hi)
                ])

    def __iter__(self) -> Iterator[SeedBatch]:
        for row in self.rows():
            yield SeedBatch(packed=torch.from_numpy(row).to(self.device), csr=self.csr,
                            num_seeds=self._shard_size, labeled=self.node_labels is not None)


def pack_epoch(loader: DeviceSeedLoader) -> torch.Tensor:
    """One epoch of a :class:`DeviceSeedLoader` as one ``[steps, 3 + 2S]``
    int32 tensor on the loader's device (``[steps, D_local, 3 + 2S]`` for a
    sharded one): numpy all the way, one copy (advances the loader's epoch,
    as iterating it does)."""
    rows = list(loader.rows())
    packed = np.stack(rows) if rows else np.zeros((0,) + loader.row_shape, np.int32)
    return torch.from_numpy(packed).to(loader.device)


def pack_epoch_sharded(loader: DeviceSeedLoader) -> torch.Tensor:
    """One epoch of a sharded :class:`DeviceSeedLoader` as one ``[steps,
    D_local, 3 + 2S]`` int32 tensor: the rows its iterator would yield step
    by step, stacked (advances the loader's epoch)."""
    if loader.num_shards is None:
        raise ValueError("pack_epoch_sharded needs a sharded DeviceSeedLoader (num_shards=D); "
                         "use pack_epoch for the single-device path")
    return pack_epoch(loader)


class DeviceSampledModel(nn.Module):
    """A node model that takes a :class:`SeedBatch` and samples on the
    device before delegating, so the whole step (sampling, forward,
    backward) runs there.

    Its ``state_dict`` is the inner model's, so checkpoints are
    interchangeable with :class:`~connectome_gnn_tpu_torch.models.node_coo.
    NodeGCN` / ``NodeSAGE``.  The CSR is not a buffer: ``to()`` leaves it
    where it is, and a batch whose row lies on another device than the CSR
    is refused.
    """

    def __init__(self, csr: DeviceGraphCSR, inner: nn.Module, fanout: Sequence[int], *,
                 dedup: bool = True):
        super().__init__()
        self.csr = csr
        self.inner = inner
        self.fanout = tuple(int(f) for f in fanout)
        self.dedup = bool(dedup)
        if not self.dedup and not getattr(inner, "multiset_safe", False):
            # the multiset mode gives every draw its own slot, which changes
            # the meaning of a sender-degree normalization (GCN's); SAGE's
            # receiver-side weighted mean is invariant to it
            raise ValueError(
                "dedup=False (multiset sampling) is only valid for SAGE-family inners declaring "
                "multiset_safe = True: sender-degree normalization changes meaning under "
                "duplicated sender slots"
            )

    def state_dict(self, *args, **kwargs):
        return self.inner.state_dict(*args, **kwargs)

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        return self.inner.load_state_dict(state_dict, strict=strict, assign=assign)

    def make_loader(self, seed_pool, node_labels=None, **kw) -> DeviceSeedLoader:
        """A :class:`DeviceSeedLoader` whose batches name this model's CSR,
        on its device."""
        return DeviceSeedLoader(seed_pool, node_labels, csr=self.csr, **kw)

    def forward(self, batch: SeedBatch) -> torch.Tensor:
        csr = batch.csr if batch.csr is not None else self.csr
        if csr.device != batch.packed.device:
            raise ValueError(
                f"the DeviceGraphCSR lies on {csr.device} and the batch on {batch.packed.device}: "
                "build the CSR on the device the model trains on (from_graph(device=...))"
            )
        sampled = device_sample(csr, batch.seeds, batch.key_words, self.fanout, dedup=self.dedup)
        sampled = dataclasses.replace(sampled, labels=batch.labels, label_mask=batch.label_mask,
                                      seed_mask=batch.seed_mask)
        return self.inner(sampled)


def _device_sampled(graph, inner_class, fanout, hidden_dim, num_classes, dropout, dedup,
                    feature_dtype, in_degree_cap, device) -> DeviceSampledModel:
    csr = DeviceGraphCSR.from_graph(graph, feature_dtype=feature_dtype,
                                    in_degree_cap=in_degree_cap, device=device)
    inner = inner_class(in_channels=graph.num_features, hidden_dim=hidden_dim,
                        num_classes=num_classes, num_layers=len(tuple(fanout)), dropout=dropout)
    return DeviceSampledModel(csr, inner.to(csr.device), fanout, dedup=dedup)


def device_sampled_gcn(
    graph: ConnectomeGraph,
    *,
    hidden_dim: int = 64,
    num_classes: int = 2,
    fanout: Sequence[int] = (10, 10),
    dropout: float = 0.0,
    feature_dtype: str = "float32",
    in_degree_cap: Optional[int] = None,
    device=None,
) -> DeviceSampledModel:
    """Upload ``graph`` to ``device`` (default ``cuda``) and wrap a matching
    :class:`~connectome_gnn_tpu_torch.models.node_coo.BlockedNodeGCN`
    (``num_layers = len(fanout)``)."""
    from connectome_gnn_tpu_torch.models.node_coo import BlockedNodeGCN

    return _device_sampled(graph, BlockedNodeGCN, fanout, hidden_dim, num_classes, dropout, True,
                           feature_dtype, in_degree_cap, device)


def device_sampled_sage(
    graph: ConnectomeGraph,
    *,
    hidden_dim: int = 64,
    num_classes: int = 2,
    fanout: Sequence[int] = (10, 10),
    dropout: float = 0.0,
    dedup: bool = True,
    feature_dtype: str = "float32",
    in_degree_cap: Optional[int] = None,
    device=None,
) -> DeviceSampledModel:
    """Upload ``graph`` to ``device`` (default ``cuda``) and wrap a matching
    :class:`~connectome_gnn_tpu_torch.models.node_coo.BlockedNodeSAGE`
    (``num_layers = len(fanout)``).  ``dedup=False`` is the multiset mode
    (:func:`device_sample`), valid for SAGE only."""
    from connectome_gnn_tpu_torch.models.node_coo import BlockedNodeSAGE

    return _device_sampled(graph, BlockedNodeSAGE, fanout, hidden_dim, num_classes, dropout, dedup,
                           feature_dtype, in_degree_cap, device)
