"""Graph-sharded device-side sampling: the giant graph's adjacency and
features are node-partitioned over the mesh, and no device holds the whole
graph.

The port of ``connectome_gnn_tpu/parallel/sharded_sampling.py``.  Nodes
split into ``D`` contiguous ranges of ``P`` (:class:`ShardedGraphCSR`); a
shard holds its range's in-adjacency rows, packed (sender, weight bits)
pairs, and its feature rows.  Each hop of the fanout sample resolves the
frontier's rows at their owners through the mesh's collectives
(:class:`~connectome_gnn_tpu_torch.parallel.mesh.Mesh`), and a rank answers
for all of its ``D_local`` shards at once: one collective a round and
direction, whatever ``D_local`` is.

Two exchanges, chosen by ``compaction``:

* **broadcast** (``compaction=None``, the oracle): ``all_gather`` every
  shard's frontier, every owner answers every request slot (masked to what
  it owns), ``all_to_all`` the packed answers back, and each slot keeps its
  owner's.  Exact, and ``D×`` the least payload;
* **compacted** (:class:`CompactionConfig`): requests a shard owns are
  answered locally, with no collective; remote ones are bucketed per owner
  with a static capacity ``C = ceil(alpha·n/D)`` a (requester → owner) pair
  and a round, and ``rounds`` compacted ``all_to_all`` exchanges carry them.
  Bitwise equal to the broadcast exchange whenever no pair carries more
  than ``rounds·C`` requests; beyond that the requests past the capacity
  are dropped (they draw nothing and read zero features) and counted
  (:func:`sharded_device_sample_with_stats`, the train step's overflow).

**The draws.**  An owner draws the uniforms for requester ``r``'s frontier
slot ``s`` at hop ``h`` from its own row key: JAX draws
``uniform(fold_in(fold_in(sub, r), s))`` with ``sub`` split from the owner's
key.  So a draw is a function of (the owner's key, the hop, the requester's
global shard index, the slot), the same whichever exchange carries it;
that is why compacted equals broadcast bitwise, and why two shards with
different keys draw differently for one node.  The port keeps that keying:
by default the draws are a counter-based integer hash of those four inputs
in torch ops (:func:`owner_draws`, bitwise the same on the CPU and the
card); ``draws=`` takes given uniforms instead, one ``[D_local (owner), D
(requester), Fb, max_deg]`` tensor a hop, which is how the tests feed
JAX's and get JAX's sample bitwise.

Sampling is the multiset mode of :func:`~connectome_gnn_tpu_torch.data.
device_sampling.device_sample` (every draw its own node slot, so no global
relabel table), which limits the models to the SAGE family; with ``fanout >=
max_in_degree`` the eval logits equal the unsharded multiset sampler's.
Ids, slots and features carry no gradient: the exchanges run without
autograd.  The train step runs a rank's shards as one batch, seeds first
(:func:`~connectome_gnn_tpu_torch.parallel.data_parallel.merge_sampled`),
with sync-BatchNorm and one gradient reduction.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from connectome_gnn_tpu_torch.data.batch import card_by_default
from connectome_gnn_tpu_torch.data.device_sampling import (
    _GOLDEN,
    _M32,
    _mix32,
    _mul32,
    cap_in_degree_mask,
)
from connectome_gnn_tpu_torch.data.graph import ConnectomeGraph
from connectome_gnn_tpu_torch.data.sampled import HopBlock, SampledNodeBatch, _sample_seed
from connectome_gnn_tpu_torch.parallel.data_parallel import merge_sampled
from connectome_gnn_tpu_torch.parallel.mesh import Mesh
from connectome_gnn_tpu_torch.parallel.shard_forward import (
    masked_ce_sum,
    reduce_gradients,
    synced_batch_norm,
    use_shard_generators,
)


@dataclasses.dataclass(frozen=True)
class CompactionConfig:
    """Static knobs of the compacted exchange.

    alpha
        Capacity factor: a (requester → owner) bucket holds ``C = ceil(alpha
        · n / D)`` requests a round (``n`` the hop's frontier or the feature
        stage's node budget).  Requests answered locally take no capacity.
    rounds
        Masked carry-over rounds: exact up to ``rounds·C`` remote requests a
        pair; payload grows linearly in ``rounds``.
    dedup_features
        Request each remote id once in the feature stage and copy the row to
        its duplicate slots, so the capacity bounds unique remote ids.  The
        draw requests never dedup: their randomness is keyed by slot.
    alpha_features / rounds_features
        The feature stage's own ``alpha`` / ``rounds`` (``None``: the draw
        stages').  :func:`plan_compaction` picks both from measured loads.
    """

    alpha: float = 2.0
    rounds: int = 2
    dedup_features: bool = True
    alpha_features: Optional[float] = None
    rounds_features: Optional[int] = None

    @property
    def feature_rounds(self) -> int:
        return self.rounds if self.rounds_features is None else int(self.rounds_features)

    def capacity(self, n: int, D: int) -> int:
        return max(1, -(-int(round(self.alpha * n)) // D))

    def feature_capacity(self, n: int, D: int) -> int:
        a = self.alpha if self.alpha_features is None else self.alpha_features
        return max(1, -(-int(round(a * n)) // D))


@dataclasses.dataclass
class ShardedGraphCSR:
    """A node-partitioned CSR: shard ``d`` owns global nodes ``[d·P,
    (d+1)·P)`` (``P = nodes_per_shard``; the id space is padded to ``D·P``,
    padded nodes have degree 0 and zero features).  The tensors hold the
    shards ``[shard_lo, shard_lo + held)`` as a leading axis.

    ``indptr[i]`` indexes shard-local edge storage; ``sender_weight[i]`` is
    the packed (global sender id, float32 weight bits) rows of the shard's
    in-edges, padded to the largest shard's edge count.  ``num_shards``,
    ``nodes_per_shard`` and ``max_in_degree`` are global, whatever range
    is held.
    """

    indptr: torch.Tensor  # int32 [held, P + 1]
    sender_weight: torch.Tensor  # int32 [held, E_max, 2]
    node_features: torch.Tensor  # float32 [held, P, F]
    nodes_per_shard: int = 0
    max_in_degree: int = 0
    num_nodes: int = 0
    num_shards: int = 0
    shard_lo: int = 0

    @property
    def held(self) -> int:
        return int(self.indptr.shape[0])

    @property
    def device(self) -> torch.device:
        return self.indptr.device

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.indptr, self.sender_weight, self.node_features))

    def to(self, device) -> "ShardedGraphCSR":
        return dataclasses.replace(self, indptr=self.indptr.to(device),
                                   sender_weight=self.sender_weight.to(device),
                                   node_features=self.node_features.to(device))

    @classmethod
    def partition(cls, graph: ConnectomeGraph, num_shards: int, *,
                  in_degree_cap: Optional[int] = None, device=None) -> "ShardedGraphCSR":
        """Every shard of ``graph``, built on the host (one receiver sort)
        and uploaded to ``device`` (default ``cuda``; ``device="cpu"`` for
        the CPU).  For a graph that does not fit the host, or to build one
        rank's shards, use :meth:`partition_streamed`.

        ``in_degree_cap`` keeps each node's ``cap`` largest-``|weight|``
        in-edges (:func:`~connectome_gnn_tpu_torch.data.device_sampling.
        cap_in_degree_mask`), bounding ``max_in_degree`` and the owner-side
        draw buffers with it.
        """
        device = card_by_default(device, "ShardedGraphCSR.partition")
        D = int(num_shards)
        N = graph.num_nodes
        P = -(-N // D)
        F = graph.num_features

        src, dst = graph.edge_index
        w_all = graph.edge_weight
        if in_degree_cap is not None:
            keep = cap_in_degree_mask(dst, w_all, in_degree_cap)
            src, dst, w_all = src[keep], dst[keep], w_all[keep]
        order = np.argsort(dst, kind="stable")
        src = src[order].astype(np.int64)
        dst = dst[order].astype(np.int64)
        w = w_all[order].astype(np.float32)

        counts = np.bincount(dst, minlength=D * P)
        max_deg = int(counts.max()) if counts.size else 0
        starts = np.searchsorted(dst, np.arange(D) * P)  # dst sorted: contiguous a shard
        ends = np.searchsorted(dst, (np.arange(D) + 1) * P)
        e_max = int((ends - starts).max()) if D else 0

        indptr = np.zeros((D, P + 1), np.int32)
        sw = np.zeros((D, max(e_max, 1), 2), np.int32)
        feats = np.zeros((D, P, F), np.float32)
        for d in range(D):
            lo, hi = starts[d], ends[d]
            np.cumsum(counts[d * P : (d + 1) * P], out=indptr[d, 1:])
            sw[d, : hi - lo, 0] = src[lo:hi]
            sw[d, : hi - lo, 1] = w[lo:hi].view(np.int32)
            n_here = min(P, N - d * P)
            if n_here > 0:
                feats[d, :n_here] = graph.node_features[d * P : d * P + n_here]
        return cls._upload(indptr, sw, feats, P, max_deg, N, D, 0, device)

    @classmethod
    def _upload(cls, indptr, sw, feats, P, max_deg, N, D, lo, device) -> "ShardedGraphCSR":
        t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
        return cls(indptr=t(indptr), sender_weight=t(sw), node_features=t(feats),
                   nodes_per_shard=P, max_in_degree=max_deg, num_nodes=N, num_shards=D,
                   shard_lo=lo)

    @classmethod
    def partition_streamed(
        cls,
        edge_chunks,
        node_features,
        num_nodes: int,
        num_shards: int,
        *,
        shard_range: Optional[tuple] = None,
        in_degree_cap: Optional[int] = None,
        device=None,
    ) -> "ShardedGraphCSR":
        """The shards ``shard_range = (lo, hi)`` (default: all) from a
        chunked COO stream: the process materializes only its range, never
        the whole graph, bitwise :meth:`partition`'s rows of it.

        ``edge_chunks`` is a zero-argument callable returning a fresh
        iterator of ``(src, dst, weight)`` numpy chunks, in the same order
        each time (pass 1 counts in-degrees, an ``O(N)`` host array; pass 2
        routes owned edges into their slots).  ``node_features`` is the
        ``[N, F]`` array or a callable ``(a, b) -> [b - a, F]``.
        ``in_degree_cap`` applies :meth:`partition`'s top-``|weight|`` clamp
        streamed: a hub (degree > cap) gets a threshold (the cap-th largest
        ``|w|``, from one more pass over hub edges) and a tie budget, so
        pass 2 keeps exactly the edges the in-memory rule keeps.
        """
        device = card_by_default(device, "ShardedGraphCSR.partition_streamed")
        D = int(num_shards)
        N = int(num_nodes)
        P = -(-N // D)
        lo_s, hi_s = shard_range if shard_range is not None else (0, D)
        if not (0 <= lo_s < hi_s <= D):
            raise ValueError(f"bad shard_range {(lo_s, hi_s)} for D={D}")
        nloc = hi_s - lo_s

        # pass 1: global in-degree counts
        counts = np.zeros(D * P, np.int64)
        for src, dst, w in edge_chunks():
            counts += np.bincount(np.asarray(dst, np.int64), minlength=D * P)

        # pass 1.5 (cap only): a hub's |w| threshold and tie budget
        cap_state = None
        if in_degree_cap is not None:
            cap = int(in_degree_cap)
            if cap < 1:
                raise ValueError(f"in_degree_cap must be >= 1, got {cap}")
            hub = counts > cap
            if hub.any():
                hub_nodes = np.flatnonzero(hub)
                hub_idx = np.full(D * P, -1, np.int64)
                hub_idx[hub_nodes] = np.arange(len(hub_nodes))
                hoff = np.zeros(len(hub_nodes) + 1, np.int64)
                np.cumsum(counts[hub_nodes], out=hoff[1:])
                hvals = np.empty(hoff[-1], np.float32)
                hcur = np.zeros(len(hub_nodes), np.int64)
                for src, dst, w in edge_chunks():
                    dst = np.asarray(dst, np.int64)
                    aw = np.abs(np.asarray(w, np.float32))
                    m = hub[np.clip(dst, 0, D * P - 1)] & (dst < D * P)
                    if not m.any():
                        continue
                    hi_ = hub_idx[dst[m]]
                    o = np.argsort(hi_, kind="stable")
                    hi_o, av_o = hi_[o], aw[m][o]
                    rank = np.arange(len(hi_o)) - np.searchsorted(hi_o, hi_o)
                    hvals[hoff[hi_o] + hcur[hi_o] + rank] = av_o
                    np.add.at(hcur, hi_o, 1)
                thr = np.zeros(D * P, np.float32)
                budget0 = np.zeros(D * P, np.int64)
                for h, gid in enumerate(hub_nodes):
                    vals = hvals[hoff[h] : hoff[h + 1]]
                    tv = np.partition(vals, len(vals) - cap)[len(vals) - cap]  # the cap-th largest
                    thr[gid] = tv
                    budget0[gid] = cap - int((vals > tv).sum())
                cap_state = (hub, thr, budget0, np.zeros(D * P, np.int64))
                counts = np.minimum(counts, cap)

        max_deg = int(counts.max()) if counts.size else 0
        e_max = int(counts.reshape(D, P).sum(axis=1).max()) if D else 0

        indptr = np.zeros((nloc, P + 1), np.int32)
        for i in range(nloc):
            d = lo_s + i
            indptr[i, 1:] = np.cumsum(counts[d * P : (d + 1) * P])
        sw = np.zeros((nloc, max(e_max, 1), 2), np.int32)
        cursor = np.zeros(nloc * P, np.int64)

        # pass 2: owned edges straight into their slots
        node_lo, node_hi = lo_s * P, hi_s * P
        for src, dst, w in edge_chunks():
            src = np.asarray(src, np.int64)
            dst = np.asarray(dst, np.int64)
            w = np.asarray(w, np.float32)
            sel = (dst >= node_lo) & (dst < node_hi)
            if not sel.any():
                continue
            s, dloc, wv = src[sel], dst[sel] - node_lo, w[sel]
            # stable order within a chunk a destination: the receiver sort's
            order = np.argsort(dloc, kind="stable")
            s, dloc, wv = s[order], dloc[order], wv[order]
            if cap_state is not None:
                hub_m, thr, budget0, tie_seen = cap_state
                gid = dloc + node_lo
                ih = hub_m[gid]
                if ih.any():
                    aw = np.abs(wv)
                    keep = ~ih | (aw > thr[gid])
                    ties = ih & (aw == thr[gid])
                    if ties.any():
                        tg = gid[ties]  # ascending (dloc sorted)
                        rank_t = np.arange(len(tg)) - np.searchsorted(tg, tg)
                        keep[ties] = (tie_seen[tg] + rank_t) < budget0[tg]
                        np.add.at(tie_seen, tg, 1)
                    s, dloc, wv = s[keep], dloc[keep], wv[keep]
                    if len(dloc) == 0:
                        continue
            rank = np.arange(len(dloc)) - np.searchsorted(dloc, dloc)
            shard = dloc // P
            v = dloc - shard * P
            slot = indptr[shard, v] + cursor[dloc] + rank
            sw[shard, slot, 0] = s
            sw[shard, slot, 1] = wv.view(np.int32)
            np.add.at(cursor, dloc, 1)

        feats = None
        for i in range(nloc):
            d = lo_s + i
            a, b = d * P, min((d + 1) * P, N)
            if b <= a:
                continue
            block = node_features(a, b) if callable(node_features) else node_features[a:b]
            block = np.asarray(block, np.float32)
            if feats is None:
                feats = np.zeros((nloc, P, block.shape[1]), np.float32)
            feats[i, : b - a] = block
        if feats is None:
            feats = np.zeros((nloc, P, 1), np.float32)
        return cls._upload(indptr, sw, feats, P, max_deg, N, D, lo_s, device)


def shard_csr(g: ShardedGraphCSR, mesh: Mesh, axis_name: str = "data") -> ShardedGraphCSR:
    """``g`` placed for this rank: the shards ``[mesh.lo, mesh.hi)`` on the
    mesh's device (``g`` itself when it is that already).  ``g`` may hold
    every shard or any range that covers the rank's."""
    D = mesh.axis_size(axis_name)
    if g.num_shards != D:
        raise ValueError(
            f"ShardedGraphCSR has {g.num_shards} shards but mesh axis '{axis_name}' has {D} "
            f"shards: repartition the graph (ShardedGraphCSR.partition(graph, {D}))")
    if D != mesh.size:
        raise ValueError(f"graph-sharded sampling runs over a 1-D mesh; axis '{axis_name}' holds "
                         f"{D} of its {mesh.size} shards")
    lo, hi = mesh.lo, mesh.hi
    if g.shard_lo == lo and g.held == hi - lo and g.device == mesh.device:
        return g
    if not (g.shard_lo <= lo and hi <= g.shard_lo + g.held):
        raise ValueError(f"the partition holds shards [{g.shard_lo}, {g.shard_lo + g.held}) and "
                         f"this rank owns [{lo}, {hi})")
    sl = slice(lo - g.shard_lo, hi - g.shard_lo)
    return dataclasses.replace(g, indptr=g.indptr[sl].to(mesh.device),
                               sender_weight=g.sender_weight[sl].to(mesh.device),
                               node_features=g.node_features[sl].to(mesh.device), shard_lo=lo)


def _check_placed(g: ShardedGraphCSR, mesh: Mesh, axis_name: str) -> None:
    if g.num_shards != mesh.axis_size(axis_name) or g.shard_lo != mesh.lo \
            or g.held != mesh.local_shards:
        raise ValueError(f"the ShardedGraphCSR holds shards [{g.shard_lo}, {g.shard_lo + g.held}) "
                         f"of {g.num_shards}; this rank owns [{mesh.lo}, {mesh.hi}) of "
                         f"{mesh.size}: place it with shard_csr(csr, mesh)")


# ---------------------------------------------------------------------------
# The draws and the owner's answer
# ---------------------------------------------------------------------------


def owner_draws(key_words: torch.Tensor, hop: int, requester: torch.Tensor, slots: torch.Tensor,
                max_deg: int) -> torch.Tensor:
    """The owners' uniforms ``[D_local, ..., max_deg]`` in ``[0, 1)`` (24
    bits) for requests of ``requester`` (global shard index) at frontier
    ``slots`` (-1 reads slot 0), hop ``hop``: a counter-based integer hash of
    owner row ``i``'s key ``key_words[i]`` (int64 ``[D_local, 2]``, hi and
    lo), the hop, the requester and the slot.  ``requester`` and ``slots``
    carry the owner-row axis first (of size 1 or ``D_local``) and broadcast
    against each other."""
    k = key_words.long() & _M32
    stream = _mix32(_mix32(k[:, 1]) ^ k[:, 0])
    stream = _mix32(stream ^ (((hop + 1) * _GOLDEN) & _M32))
    shape = torch.broadcast_shapes(requester.shape, slots.shape)
    stream = stream.view((-1,) + (1,) * (len(shape) - 1))
    per_req = _mix32(stream ^ _mul32(requester.long() + 1, _GOLDEN))[..., None]
    counter = slots.long().clamp(min=0)[..., None] * max_deg + torch.arange(
        max_deg, device=slots.device)
    bits = _mix32(_mix32((counter & _M32) ^ per_req) ^ per_req)
    return (bits >> 8).float() * 2.0**-24


def _uniforms(key_words, draws, hop, requester, slots, max_deg) -> torch.Tensor:
    """:func:`owner_draws`, or the given ``draws[hop]`` ``[D_local, D, Fb,
    max_deg]`` read at ``(owner row, requester, slot)``."""
    if draws is None:
        return owner_draws(key_words, hop, requester, slots, max_deg)
    d = draws[hop]
    rows = torch.arange(d.shape[0], device=d.device).view(
        (-1,) + (1,) * (max(requester.dim(), slots.dim()) - 1))
    return d[rows, requester.long(), slots.long().clamp(min=0)]


def _owner_answer(g: ShardedGraphCSR, nodes: torch.Tensor, u: torch.Tensor, f_eff: int):
    """Fanout draws for request ``nodes`` (int64 ``[D_local, ...]`` global
    ids, -1 none) against local owner ``i``'s rows (row ``i``); ``u`` the
    uniforms ``[D_local, ..., max_deg]``.  Returns int32 ``[D_local, ...,
    f_eff, 2]`` (sender id, weight bits): sender -1 and bits 0 where the
    node is not owned there, invalid, or has fewer than ``f_eff`` in-edges.
    The top ``f_eff`` draws are ``lax.top_k``'s, ties to the lower slot (a
    stable descending sort)."""
    Dl, P = g.held, g.nodes_per_shard
    Emax = int(g.sender_weight.shape[1])
    dev = nodes.device
    row = torch.arange(Dl, device=dev).view((-1,) + (1,) * (nodes.dim() - 1))
    lo = (g.shard_lo + row) * P
    owned = (nodes >= lo) & (nodes < lo + P)
    nl = (nodes - lo).clamp(0, P - 1)
    ip = g.indptr.long().reshape(-1)
    at = row * (P + 1) + nl
    start = ip[at]
    deg = torch.where(owned, ip[at + 1] - start, 0)
    md = u.shape[-1]
    scores = torch.where(torch.arange(md, device=dev) < deg[..., None], u, -1.0)
    vals, pos = torch.sort(scores, dim=-1, descending=True, stable=True)
    vals, pos = vals[..., :f_eff], pos[..., :f_eff]
    evalid = (vals >= 0.0) & owned[..., None]
    eid = (start[..., None] + pos).clamp(0, Emax - 1) + (row * Emax)[..., None]
    pairs = g.sender_weight.reshape(-1, 2)[eid]  # [..., f, 2]
    snd = torch.where(evalid, pairs[..., 0], -1)
    wbits = torch.where(evalid, pairs[..., 1], 0)
    return torch.stack([snd, wbits], dim=-1)


def _owned_rows(g: ShardedGraphCSR, nodes: torch.Tensor) -> torch.Tensor:
    """Feature rows of ``nodes [D_local, ...]`` at local owner ``i`` (row
    ``i``), zeros where it does not own the node."""
    Dl, P = g.held, g.nodes_per_shard
    row = torch.arange(Dl, device=nodes.device).view((-1,) + (1,) * (nodes.dim() - 1))
    lo = (g.shard_lo + row) * P
    owned = (nodes >= lo) & (nodes < lo + P)
    rows = g.node_features.reshape(Dl * P, -1)[row * P + (nodes - lo).clamp(0, P - 1)]
    return torch.where(owned[..., None], rows, 0.0)


# ---------------------------------------------------------------------------
# The exchanges
# ---------------------------------------------------------------------------


def _exchange_select(mesh: Mesh, axis_name: str, local_answers: torch.Tensor,
                     owner: torch.Tensor) -> torch.Tensor:
    """Route owner-computed answers back and keep each slot's owner's.

    ``local_answers [D_local, D, L, ...]``: what local owner ``i`` computed
    for every (requester, slot).  After the ``all_to_all`` axis 1 indexes
    the owner that computed each block for the requester; ``owner
    [D_local, L]`` picks the authoritative one."""
    ex = mesh.all_to_all(local_answers, axis_name)
    Dl, L = owner.shape
    idx = owner.view((Dl, 1, L) + (1,) * (ex.dim() - 3)).expand((Dl, 1, L) + tuple(ex.shape[3:]))
    return ex.gather(1, idx).squeeze(1)


def _compact_schedule(ids, owner, eligible, D: int, C: int, R: int):
    """Give each eligible request slot a (round, owner-bucket position) by
    one stable sort by owner, row by row: rank ``r`` within the owner's
    group goes to round ``r // C``, position ``r % C``.  Returns
    ``req_ids [B, R, D, C]`` (global id, -1 pad), ``req_slot [B, R, D, C]``
    (requester-local slot, -1 pad) and the overflow ``[B]`` (eligible
    slots ranked past ``R·C``)."""
    B, n = ids.shape
    iota = torch.arange(n, device=ids.device).expand(B, n)
    okey = torch.where(eligible, owner, D)
    sk, order = torch.sort(okey, dim=1, stable=True)
    elig_sorted = sk < D
    first = elig_sorted & torch.cat([torch.ones_like(sk[:, :1], dtype=torch.bool),
                                     sk[:, 1:] != sk[:, :-1]], dim=1)
    gstart = torch.cummax(torch.where(first, iota, -1), dim=1).values
    rank = iota - gstart
    return _fill_buckets(ids, order, sk, rank, elig_sorted, D, C, R)


def _fill_buckets(ids, order, sk, rank, sched, D, C, R):
    """The buckets of the scheduled sorted positions ``sched`` (their owner
    ``sk`` and rank), and the count ranked past ``R·C``."""
    B = ids.shape[0]
    rnd = torch.div(rank, C, rounding_mode="floor")
    pos = rank - rnd * C
    ok = sched & (rnd < R)
    overflow = (sched & (rnd >= R)).sum(dim=1)
    flat = torch.where(ok, (rnd * D + sk) * C + pos, R * D * C)  # R·D·C: the dump slot

    def buckets(values):
        out = values.new_full((B, R * D * C + 1), -1)
        return out.scatter_(1, flat, values)[:, :-1].reshape(B, R, D, C)

    return buckets(ids.gather(1, order)), buckets(order), overflow


def _compact_schedule_dedup(ids, owner, eligible, D: int, C: int, R: int, id_space: int):
    """As :func:`_compact_schedule`, but each distinct (owner, id) pair is
    scheduled once, at its first slot, and ``dup_src [B, n]`` names, for
    every slot, the first slot of its id (itself where local or invalid):
    gathering the answered buffer through it copies answers to duplicates.
    One stable sort by (owner, id), as one int64 key (ids below
    ``id_space``)."""
    B, n = ids.shape
    iota = torch.arange(n, device=ids.device).expand(B, n)
    okey = torch.where(eligible, owner, D)
    idkey = torch.where(eligible, ids, -1)
    M = id_space + 1
    skey, order = torch.sort(okey * M + idkey + 1, dim=1, stable=True)
    sk = torch.div(skey, M, rounding_mode="floor")
    elig_sorted = sk < D
    ones = torch.ones_like(sk[:, :1], dtype=torch.bool)
    uniq = elig_sorted & torch.cat([ones, skey[:, 1:] != skey[:, :-1]], dim=1)
    grp_first = elig_sorted & torch.cat([ones, sk[:, 1:] != sk[:, :-1]], dim=1)
    u_idx = torch.cumsum(uniq.long(), dim=1) - 1  # the unique ordinal
    rank = u_idx - torch.cummax(torch.where(grp_first, u_idx, -1), dim=1).values
    req_ids, req_slot, overflow = _fill_buckets(ids, order, sk, rank, uniq, D, C, R)
    pfirst = torch.cummax(torch.where(uniq, iota, -1), dim=1).values
    src_sorted = torch.where(elig_sorted, order.gather(1, pfirst.clamp(min=0)), order)
    dup_src = torch.zeros_like(order).scatter_(1, order, src_sorted)
    return req_ids, req_slot, overflow, dup_src


def _compacted_rounds(mesh: Mesh, axis_name: str, req_ids, req_slot, answer_fn, out_buf):
    """The ``R`` compacted request and answer exchanges, the answers
    scattered into ``out_buf [D_local, n, ...]`` at their requester slots.
    ``answer_fn(nodes [D_local, D, C], slots [D_local, D, C]) -> [D_local,
    D, C, ...]`` runs owner-side: after the request ``all_to_all`` axis 1
    indexes the requester."""
    Dl, R, D, C = req_ids.shape
    n = out_buf.shape[1]
    buf = torch.cat([out_buf, out_buf[:, :1]], dim=1)  # row n: the dump row
    rows = torch.arange(Dl, device=buf.device)[:, None]
    for r in range(R):
        req = torch.stack([req_ids[:, r], req_slot[:, r]], dim=-1).int()  # [Dl, D, C, 2]
        recv = mesh.all_to_all(req, axis_name).long()
        back = mesh.all_to_all(answer_fn(recv[..., 0], recv[..., 1]), axis_name)
        tgt = torch.where(req_slot[:, r] >= 0, req_slot[:, r], n).reshape(Dl, D * C)
        buf[rows, tgt] = back.reshape((Dl, D * C) + tuple(back.shape[3:]))
    return buf[:, :n]


# ---------------------------------------------------------------------------
# The sampler
# ---------------------------------------------------------------------------


def sharded_device_sample(g: ShardedGraphCSR, seeds, key_words, fanout: Sequence[int], mesh: Mesh,
                          *, axis_name: str = "data",
                          compaction: Optional[CompactionConfig] = None, draws=None) -> list:
    """The multiset fanout sample of every local shard, one
    :class:`~connectome_gnn_tpu_torch.data.sampled.SampledNodeBatch` each
    (seeds first, then each hop's draws; ``node_ids`` global), with the
    graph node-partitioned over ``mesh``.  ``g`` is placed for this rank
    (:func:`shard_csr`); ``seeds [D_local, S]`` (-1 padding) and
    ``key_words [D_local, 2]`` are the rank's rows.  ``compaction`` picks
    the compacted exchange (overflow dropped here: see
    :func:`sharded_device_sample_with_stats`); ``draws`` as in the module
    docstring."""
    return sharded_device_sample_with_stats(g, seeds, key_words, fanout, mesh, axis_name=axis_name,
                                            compaction=compaction, draws=draws)[0]


def sharded_device_sample_with_stats(g: ShardedGraphCSR, seeds, key_words, fanout: Sequence[int],
                                     mesh: Mesh, *, axis_name: str = "data",
                                     compaction: Optional[CompactionConfig] = None, draws=None):
    """As :func:`sharded_device_sample`, returning ``(batches, overflow)``
    with ``overflow`` the int64 ``[D_local]`` count of request slots each
    local shard's compacted exchange dropped (0 for the broadcast one)."""
    _check_placed(g, mesh, axis_name)
    with torch.no_grad():
        return _sample(g, seeds.to(g.device).long(), key_words.to(g.device), fanout, mesh,
                       axis_name, compaction, draws)


def _sample(g, seeds, key_words, fanout, mesh, axis_name, compaction, draws):
    dev = seeds.device
    Dl, S = seeds.shape
    D, P = g.num_shards, g.nodes_per_shard
    me = (g.shard_lo + torch.arange(Dl, device=dev))[:, None]
    requesters = torch.arange(D, device=dev).view(1, D, 1)
    fanout = tuple(int(f) for f in fanout)
    max_deg = max(g.max_in_degree, max(fanout) if fanout else 1, 1)

    def owner_of(ids):
        return (ids.clamp(min=0) // P).clamp(0, D - 1)

    frontier = torch.where(seeds >= 0, seeds, -1)
    frontier_start, offset = 0, S
    overflow = torch.zeros(Dl, dtype=torch.long, device=dev)
    nodes, senders, receivers, weights, blocks = [frontier], [], [], [], []
    for h, f in enumerate(fanout):
        Fb = int(frontier.shape[1])
        f_eff = min(f, max_deg)
        owner = owner_of(frontier)
        valid = frontier >= 0
        slots = torch.arange(Fb, device=dev)
        if compaction is None:
            # every shard's frontier to every owner; each answers every slot
            everyone = mesh.all_gather(frontier.int()).long()  # [D, Fb]
            u = _uniforms(key_words, draws, h, requesters, slots.view(1, 1, Fb), max_deg)
            ans = _owner_answer(g, everyone.expand(Dl, D, Fb), u, f_eff)
            packed = _exchange_select(mesh, axis_name, ans, owner)  # [Dl, Fb, f, 2]
        else:
            local = valid & (owner == me)
            u_loc = _uniforms(key_words, draws, h, me, slots[None], max_deg)
            ans_loc = _owner_answer(g, torch.where(local, frontier, -1), u_loc, f_eff)
            C = compaction.capacity(Fb, D)
            req_ids, req_slot, ovf = _compact_schedule(frontier, owner, valid & (owner != me), D, C,
                                                       compaction.rounds)
            overflow += ovf

            def edge_answer(ids, req_slots, h=h, f_eff=f_eff):
                u = _uniforms(key_words, draws, h, requesters, req_slots, max_deg)
                return _owner_answer(g, ids, u, f_eff)

            empty = torch.stack([torch.full((Dl, Fb, f_eff), -1, dtype=torch.int32, device=dev),
                                 torch.zeros((Dl, Fb, f_eff), dtype=torch.int32, device=dev)], -1)
            remote = _compacted_rounds(mesh, axis_name, req_ids, req_slot, edge_answer, empty)
            packed = torch.where(local[..., None, None], ans_loc, remote)

        snd = packed[..., 0].long()  # [Dl, Fb, f]
        wv = torch.where(snd >= 0, packed[..., 1].contiguous().view(torch.float32), 0.0)
        evalid = (snd >= 0).reshape(Dl, -1)
        rloc_rows = frontier_start + slots
        rloc = rloc_rows[:, None].expand(Fb, f_eff).reshape(-1)
        snd_final = torch.where(evalid, offset + torch.arange(Fb * f_eff, device=dev), rloc)
        frontier = torch.where(evalid, snd.reshape(Dl, -1), -1)
        nodes.append(frontier)
        senders.append(snd_final)
        receivers.append(rloc.expand(Dl, -1))
        weights.append(wv.reshape(Dl, -1))
        blocks.append((snd_final.view(Dl, Fb, f_eff), wv, rloc_rows, offset, frontier_start))
        frontier_start, offset = offset, offset + Fb * f_eff

    # features for every node slot, from their owners
    all_nodes = torch.cat(nodes, dim=1)  # [Dl, NBud]
    node_mask = all_nodes >= 0
    owner = owner_of(all_nodes)
    NBud, F = int(all_nodes.shape[1]), int(g.node_features.shape[-1])
    if compaction is None:
        everyone = mesh.all_gather(all_nodes.int()).long()  # [D, NBud]
        x = _exchange_select(mesh, axis_name, _owned_rows(g, everyone.expand(Dl, D, NBud)), owner)
    else:
        local = node_mask & (owner == me)
        x_loc = _owned_rows(g, torch.where(local, all_nodes, -1))
        C = compaction.feature_capacity(NBud, D)
        R_f = compaction.feature_rounds
        remote = node_mask & (owner != me)
        if compaction.dedup_features:
            req_ids, req_slot, ovf, dup_src = _compact_schedule_dedup(all_nodes, owner, remote, D,
                                                                      C, R_f, D * P)
        else:
            req_ids, req_slot, ovf = _compact_schedule(all_nodes, owner, remote, D, C, R_f)
            dup_src = None
        overflow += ovf
        x_rem = _compacted_rounds(mesh, axis_name, req_ids, req_slot,
                                  lambda ids, _: _owned_rows(g, ids),
                                  g.node_features.new_zeros((Dl, NBud, F)))
        if dup_src is not None:
            x_rem = x_rem.gather(1, dup_src[..., None].expand(Dl, NBud, F))
        x = torch.where(local[..., None], x_loc, x_rem)
    x = torch.where(node_mask[..., None], x, 0.0)

    cat = lambda parts, i, dtype: (torch.cat([p[i] for p in parts]) if parts  # noqa: E731
                                   else torch.zeros(0, dtype=dtype, device=dev))
    zeros = torch.zeros(S, dtype=torch.long, device=dev)
    batches = [SampledNodeBatch(
        node_features=x[i], senders=cat(senders, i, torch.long),
        receivers=cat(receivers, i, torch.long), edge_weight=cat(weights, i, torch.float32),
        node_mask=node_mask[i], labels=zeros, label_mask=zeros.bool(), seed_mask=zeros.bool(),
        node_ids=all_nodes[i], num_seeds=S,
        hop_blocks=tuple(HopBlock(senders=b[0][i], weights=b[1][i], recv=b[2], sender_start=b[3],
                                  recv_start=b[4]) for b in blocks) or None,
    ) for i in range(Dl)]
    return batches, overflow


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------


def _validate_sharded_args(mesh: Mesh, axis_name: str, g: ShardedGraphCSR, seeds) -> None:
    """The partition's shard count must be the mesh axis's size, and the
    seed stack one row a shard (all ``D`` or the rank's ``D_local``):
    otherwise the owner exchange would be mis-routed."""
    D = mesh.axis_size(axis_name)
    if g.num_shards != D:
        raise ValueError(
            f"ShardedGraphCSR has {g.num_shards} shards but mesh axis '{axis_name}' has {D} "
            f"shards: repartition the graph (ShardedGraphCSR.partition(graph, {D}))")
    if seeds.dim() != 2 or int(seeds.shape[0]) not in (D, mesh.local_shards):
        raise ValueError(f"seeds must be stacked [D, S] with D={D} (or this rank's "
                         f"{mesh.local_shards} rows), got shape {tuple(seeds.shape)}")


def _rows(mesh: Mesh, *tensors):
    return [mesh.place(torch.as_tensor(np.asarray(t)) if not torch.is_tensor(t) else t)
            for t in tensors]


def _local_draws(mesh: Mesh, draws):
    """Given draws of every owner (``[D, ...]`` a hop) or of the rank's."""
    return None if draws is None else [mesh.place(torch.as_tensor(d)) for d in draws]


def graph_sharded_batch(g, seeds, key_words, labels, label_mask, fanout, mesh, axis_name="data",
                        compaction=None, draws=None):
    """The rank's shards sampled and merged into one batch (seeds first),
    with the labels; returns ``(batch, overflow [D_local])``."""
    batches, ovf = sharded_device_sample_with_stats(g, seeds, key_words, fanout, mesh,
                                                    axis_name=axis_name, compaction=compaction,
                                                    draws=draws)
    batches = [dataclasses.replace(b, labels=labels[i].long(), label_mask=label_mask[i].bool(),
                                   seed_mask=seeds[i] >= 0) for i, b in enumerate(batches)]
    return merge_sampled(batches), ovf


def make_graph_sharded_sampled_forward(inner, mesh: Mesh, fanout: Sequence[int],
                                       axis_name: str = "data", *,
                                       compaction: Optional[CompactionConfig] = None):
    """The eval forward over the graph-sharded sampler: ``fwd(g, seeds,
    key_words, draws=None) -> logits [D_local, S, C]`` (running BatchNorm
    moments).  The inner model must be of the SAGE family."""

    def fwd(g, seeds, key_words, draws=None):
        _validate_sharded_args(mesh, axis_name, g, torch.as_tensor(seeds))
        g = shard_csr(g, mesh, axis_name)
        seeds, key_words = _rows(mesh, seeds, key_words)
        inner.eval()
        with torch.no_grad():
            batches = sharded_device_sample(g, seeds, key_words, fanout, mesh, axis_name=axis_name,
                                            compaction=compaction,
                                            draws=_local_draws(mesh, draws))
            logits = inner(merge_sampled(batches))
        return logits.view(seeds.shape[0], seeds.shape[1], -1)

    return fwd


def make_graph_sharded_train_step(inner, optimizer: torch.optim.Optimizer, mesh: Mesh,
                                  fanout: Sequence[int], axis_name: str = "data", *,
                                  guard: bool = False,
                                  compaction: Optional[CompactionConfig] = None, seed: int = 0):
    """A train step over the graph-sharded sampler: ``step(g, seeds,
    key_words, labels, label_mask, draws=None) -> (loss, n[, overflow][,
    ok])``, sync-BatchNorm, the globally masked loss and the gradients
    reduced once (:func:`~connectome_gnn_tpu_torch.parallel.shard_forward.
    reduce_gradients`), ``inner`` and ``optimizer`` updated in place.  With
    ``compaction`` the overflow summed over the mesh is appended (0: the
    step was exact); ``guard`` appends the non-finite step guard's verdict
    (a rejected step keeps every old value).  Arguments are stacked a shard:
    all ``D`` rows, or the rank's.  Dropout draws each shard's mask from
    its own generator seeded from ``seed`` (``None``: the dropout layers'
    generators as they are, the Trainer's)."""
    from connectome_gnn_tpu_torch.train.trainer import guarded_step

    if seed is not None:
        use_shard_generators(inner, mesh, seed)
    params = list(inner.parameters())

    def step(g, seeds, key_words, labels, label_mask, draws=None):
        _validate_sharded_args(mesh, axis_name, g, torch.as_tensor(seeds))
        g = shard_csr(g, mesh, axis_name)
        seeds, key_words, labels, label_mask = _rows(mesh, seeds, key_words, labels, label_mask)
        overflow = []

        def loss_and_grads():
            batch, ovf = graph_sharded_batch(g, seeds, key_words, labels, label_mask, fanout,
                                             mesh, axis_name, compaction,
                                             _local_draws(mesh, draws))
            overflow.append(ovf)
            inner.train()
            with synced_batch_norm(inner, mesh):
                logits = inner(batch)
            local_sum, local_n = masked_ce_sum(logits, batch.labels, batch.label_mask)
            local_sum.backward()
            return reduce_gradients(mesh, params, local_sum, local_n)

        loss, n, ok = guarded_step(inner, optimizer, loss_and_grads, guard)
        out = (loss, n)
        if compaction is not None:
            total = overflow[0].sum().to(torch.int32).reshape(1)
            mesh.reduce_(total, "psum")
            out += (total[0],)
        return out + ((ok,) if guard else ())

    return step


def make_graph_sharded_eval_step(inner, mesh: Mesh, fanout: Sequence[int],
                                 axis_name: str = "data", *,
                                 compaction: Optional[CompactionConfig] = None):
    """``ev(g, seeds, key_words, labels, label_mask, draws=None) ->
    (loss_sum, correct, n_real)`` summed over the mesh (the
    ``Trainer.evaluate`` contract)."""

    def ev(g, seeds, key_words, labels, label_mask, draws=None):
        _validate_sharded_args(mesh, axis_name, g, torch.as_tensor(seeds))
        g = shard_csr(g, mesh, axis_name)
        seeds, key_words, labels, label_mask = _rows(mesh, seeds, key_words, labels, label_mask)
        inner.eval()
        with torch.no_grad():
            batch, _ = graph_sharded_batch(g, seeds, key_words, labels, label_mask, fanout, mesh,
                                           axis_name, compaction, _local_draws(mesh, draws))
            logits = inner(batch)
            loss_sum, n = masked_ce_sum(logits, batch.labels, batch.label_mask)
            correct = ((logits.argmax(dim=1) == batch.labels) & batch.label_mask).sum()
            sums = mesh.all_reduce(torch.stack([loss_sum, correct.to(loss_sum.dtype), n]))
        return sums[0], sums[1], sums[2]

    return ev


# ---------------------------------------------------------------------------
# The payload model, the census and the planner
# ---------------------------------------------------------------------------


def sharded_sampling_comm_model(*, D: int, S: int, fanout: Sequence[int], F: int, max_deg: int,
                                compaction: Optional[CompactionConfig] = None) -> dict:
    """The exchange's payload in bytes received a device a step (bytes sent
    equal it), the conventions of :func:`~connectome_gnn_tpu_torch.parallel.
    comm_accounting.count_collective_bytes`.

    Frontiers under multiset sampling: ``Fb_0 = S``, ``Fb_{h+1} = Fb_h ·
    f_h``; node budget ``NBud = S + Σ_h Fb_{h+1}``.  Broadcast: a hop
    ``(D-1)·Fb·4`` frontier ``all_gather`` + ``(D-1)·Fb·f·8`` packed answers;
    features ``(D-1)·NBud·4`` ids + ``(D-1)·NBud·F·4`` rows.  Compacted
    (capacity ``C``, ``R`` rounds): a hop ``R·(D-1)·C·8`` requests +
    ``R·(D-1)·C·f·8`` answers; features ``R·(D-1)·C_f·8`` + ``R·(D-1)·C_f·F·4``.
    """
    fanout = tuple(int(f) for f in fanout)
    hop_bytes = 0
    Fb = S
    nbud = S
    for f in fanout:
        f_eff = min(f, max(max_deg, 1))
        if compaction is None:
            hop_bytes += (D - 1) * Fb * 4 + (D - 1) * Fb * f_eff * 8
        else:
            C = compaction.capacity(Fb, D)
            R = compaction.rounds
            hop_bytes += R * (D - 1) * C * 8 + R * (D - 1) * C * f_eff * 8
        Fb *= f_eff
        nbud += Fb
    if compaction is None:
        feat_bytes = (D - 1) * nbud * 4 + (D - 1) * nbud * F * 4
    else:
        C = compaction.feature_capacity(nbud, D)
        R = compaction.feature_rounds
        feat_bytes = R * (D - 1) * C * 8 + R * (D - 1) * C * F * 4
    return {
        "per_device_bytes_per_step": int(hop_bytes + feat_bytes),
        "hop_exchange_bytes": int(hop_bytes),
        "feature_exchange_bytes": int(feat_bytes),
        "node_budget": int(nbud),
    }


def _remote(ids, P, D, me):
    owner = (ids.clamp(min=0) // P).clamp(0, D - 1)
    return owner, (ids >= 0) & (owner != me)


def _census_remote_load(ids, P, D, me) -> torch.Tensor:
    """A row's largest remote request count (slots) to one owner ``[D_local]``."""
    owner, rem = _remote(ids, P, D, me)
    cnt = torch.zeros(ids.shape[0], D, dtype=torch.long, device=ids.device)
    return cnt.scatter_add_(1, owner, rem.long()).amax(dim=1)


def _census_unique_remote_load(ids, P, D, me) -> torch.Tensor:
    """A row's largest unique remote id count to one owner: the load the
    dedup'd feature schedule carries."""
    owner, rem = _remote(ids, P, D, me)
    M = D * P + 1
    skey = torch.sort(torch.where(rem, owner, D) * M + torch.where(rem, ids, -1) + 1, dim=1).values
    sk = torch.div(skey, M, rounding_mode="floor")
    uniq = (sk < D) & torch.cat([torch.ones_like(sk[:, :1], dtype=torch.bool),
                                 skey[:, 1:] != skey[:, :-1]], dim=1)
    cnt = torch.zeros(ids.shape[0], D + 1, dtype=torch.long, device=ids.device)
    return cnt.scatter_add_(1, sk, uniq.long())[:, :D].amax(dim=1)


def sharded_sampling_census(g: ShardedGraphCSR, seeds, key_words, fanout: Sequence[int],
                            mesh: Mesh, *, axis_name: str = "data", dedup_features: bool = True,
                            draws=None):
    """The exchange's peak bucket loads: runs the broadcast exchange once
    and counts, a stage, the most remote requests any (requester → owner)
    pair would carry, which the compacted exchange's ``rounds·C`` must
    cover to be exact.  The hop stages count request slots; the feature
    stage unique remote ids with ``dedup_features``, else slots.  Returns
    ``(draw_loads [hops], feature_load)``, the largest over the mesh (the
    same on every rank)."""
    batches, _ = sharded_device_sample_with_stats(g, seeds, key_words, fanout, mesh,
                                                  axis_name=axis_name, draws=draws)
    P, D = g.nodes_per_shard, g.num_shards
    me = (g.shard_lo + torch.arange(g.held, device=g.device))[:, None]
    fanout = tuple(int(f) for f in fanout)
    max_deg = max(g.max_in_degree, max(fanout) if fanout else 1, 1)
    ids = torch.stack([b.node_ids for b in batches])
    start, seg = 0, int(seeds.shape[1])
    loads = []
    for f in fanout:
        loads.append(_census_remote_load(ids[:, start : start + seg], P, D, me))
        start += seg
        seg *= min(f, max_deg)
    census = _census_unique_remote_load if dedup_features else _census_remote_load
    draw = (torch.stack(loads, dim=1) if loads
            else torch.zeros(g.held, 0, dtype=torch.long, device=g.device))
    return mesh.pmax(draw), mesh.pmax(census(ids, P, D, me))


def _alpha_for_capacity(C: int, n: int, D: int) -> float:
    """The least alpha whose ``capacity(n, D)`` is at least ``C`` (guarding
    the float round trip of the capacity formula)."""
    a = C * D / max(n, 1)
    while max(1, -(-int(round(a * n)) // D)) < C:
        a *= 1.0 + 1e-9
    return a


def probe_key_words(seed: int, steps: int, D: int) -> np.ndarray:
    """``[steps, D, 2]`` probe keys: step ``t``, shard ``d`` keyed ``(0,
    _sample_seed(seed, t, 0, d))``."""
    return np.array([[[0, _sample_seed(seed, t, 0, d)] for d in range(D)] for t in range(steps)],
                    np.int64)


def plan_compaction(
    csr: ShardedGraphCSR,
    mesh: Mesh,
    seeds,
    key_words=0,
    fanout: Sequence[int] = (),
    *,
    draws=None,
    axis_name: str = "data",
    safety: float = 1.25,
    rounds: int = 1,
    rounds_features: Optional[int] = None,
    dedup_features: bool = True,
    return_loads: bool = False,
):
    """Measure the exchange's peak loads on probe seed batches and return a
    :class:`CompactionConfig` exact on them with a ``safety`` margin, at
    near the least payload: the draw stages (``alpha``) and the feature
    stage (``alpha_features``) get capacities of their own.

    ``seeds``: ``[D, S]`` or ``[steps, D, S]`` probe seeds (row ``d`` shard
    ``d``'s, -1 padded).  ``key_words``: ``[steps, D, 2]`` keys, or an int
    seed for :func:`probe_key_words`.  ``draws``: given uniforms, a list a
    step of :func:`sharded_device_sample`'s ``draws`` (every owner's).
    ``rounds`` / ``rounds_features``: the rounds to plan for.  Every rank
    passes the same global arrays and keeps its rows; the loads are the
    largest over the mesh, so every rank plans the same config.  With
    ``return_loads`` returns ``(config, {"draw_loads", "feature_load"})``.
    """
    fanout = tuple(int(f) for f in fanout)
    seeds = np.asarray(seeds, np.int64)
    if seeds.ndim == 2:
        seeds = seeds[None]
    if seeds.ndim != 3 or seeds.shape[1] != csr.num_shards:
        raise ValueError("seeds must be [D, S] or [steps, D, S] with D == num_shards "
                         f"({csr.num_shards}); got {seeds.shape}")
    _validate_sharded_args(mesh, axis_name, csr, torch.from_numpy(seeds[0]))
    D, S, steps = csr.num_shards, int(seeds.shape[-1]), int(seeds.shape[0])
    kw = (probe_key_words(int(key_words), steps, D) if np.ndim(key_words) == 0
          else np.asarray(key_words, np.int64).reshape(steps, D, 2))
    gs = shard_csr(csr, mesh, axis_name)
    draw_max = np.zeros(len(fanout), np.int64)
    feat_max = 0
    for t in range(steps):
        seeds_t, keys_t = _rows(mesh, seeds[t], kw[t])
        dl, fl = sharded_sampling_census(gs, seeds_t, keys_t, fanout, mesh, axis_name=axis_name,
                                         dedup_features=dedup_features,
                                         draws=None if draws is None else _local_draws(mesh, draws[t]))
        draw_max = np.maximum(draw_max, dl.cpu().numpy())
        feat_max = max(feat_max, int(fl))

    R = max(1, int(rounds))
    R_f = R if rounds_features is None else max(1, int(rounds_features))
    max_deg = max(csr.max_in_degree, max(fanout) if fanout else 1, 1)
    Fb, nbud, alpha = S, S, 0.0
    for h, f in enumerate(fanout):
        C_h = max(1, int(np.ceil(safety * float(draw_max[h]) / R)))
        alpha = max(alpha, _alpha_for_capacity(C_h, Fb, D))
        Fb *= min(f, max_deg)
        nbud += Fb
    C_f = max(1, int(np.ceil(safety * float(feat_max) / R_f)))
    cfg = CompactionConfig(alpha=max(alpha, 1e-6), rounds=R, dedup_features=dedup_features,
                           alpha_features=_alpha_for_capacity(C_f, nbud, D), rounds_features=R_f)
    if return_loads:
        return cfg, {"draw_loads": draw_max.astype(int).tolist(), "feature_load": int(feat_max)}
    return cfg


# ---------------------------------------------------------------------------
# The model the Trainer drives
# ---------------------------------------------------------------------------


class GraphShardedSampledModel(nn.Module):
    """Graph-sharded sampled training through the Trainer: ``Trainer(model,
    mesh=...)`` trains and evaluates it from a sharded ``DeviceSeedLoader``
    (:meth:`make_loader`) as it does a replicated ``DeviceSampledModel``,
    but no device holds the whole graph.

    ``compaction`` (default :class:`CompactionConfig()`) picks the
    compacted exchange; ``None`` the broadcast oracle; :meth:`plan_compaction`
    adopts a measured config.  The Trainer reports the exchange's overflow
    as ``last_sampling_overflow``.  SAGE-family inners only (multiset
    sampling).  Its ``state_dict`` is the inner model's; the partition is
    not a buffer and does not move with ``to()``.
    """

    def __init__(self, csr: ShardedGraphCSR, inner: nn.Module, fanout: Sequence[int], *,
                 compaction: Optional[CompactionConfig] = CompactionConfig()):
        super().__init__()
        if not getattr(inner, "multiset_safe", False):
            raise ValueError(
                "graph-sharded sampling is multiset-mode: SAGE-family inners only "
                "(sender-degree normalization, GCN-style, changes meaning under duplicated "
                "sender slots; inners must declare multiset_safe = True)")
        self.csr = csr
        self.inner = inner
        self.fanout = tuple(int(f) for f in fanout)
        self.compaction = compaction

    def state_dict(self, *args, **kwargs):
        return self.inner.state_dict(*args, **kwargs)

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        return self.inner.load_state_dict(state_dict, strict=strict, assign=assign)

    def forward(self, batch):
        raise TypeError("a GraphShardedSampledModel runs through Trainer(mesh=...) or "
                        "make_graph_sharded_train_step / _eval_step, over a mesh")

    def make_loader(self, seed_pool, node_labels=None, **kw):
        """A sharded ``DeviceSeedLoader`` (``num_shards`` defaults to the
        partition's shard count, ``device`` to the partition's); its
        batches carry no graph: the partition is the step's argument."""
        from connectome_gnn_tpu_torch.data.device_sampling import DeviceSeedLoader

        kw.setdefault("num_shards", self.csr.num_shards)
        kw.setdefault("device", self.csr.device)
        return DeviceSeedLoader(seed_pool, node_labels, **kw)

    def plan_compaction(self, mesh: Mesh, seeds, key_words=0, *, placed_csr=None, **kw):
        """:func:`plan_compaction` on this model's partition and fanout,
        adopted as ``self.compaction``; returns what it returns.  The
        Trainer's cached steps key on the config, so it takes effect at the
        next step.  ``placed_csr``: an already placed partition to probe."""
        out = plan_compaction(placed_csr if placed_csr is not None else self.csr, mesh, seeds,
                              key_words, self.fanout, **kw)
        self.compaction = out[0] if isinstance(out, tuple) else out
        return out


def graph_sharded_sage(
    graph: ConnectomeGraph,
    num_shards: int,
    *,
    hidden_dim: int = 64,
    num_classes: int = 2,
    num_layers: int = 2,
    fanout: Sequence[int] = (10, 10),
    compaction: Optional[CompactionConfig] = CompactionConfig(),
    in_degree_cap: Optional[int] = None,
    device=None,
) -> GraphShardedSampledModel:
    """Partition ``graph`` into ``num_shards`` node ranges on ``device``
    (default ``cuda``; ``device="cpu"`` for the CPU) and wrap a
    :class:`~connectome_gnn_tpu_torch.models.node_coo.BlockedNodeSAGE`
    (weights from a generator seeded 0).  ``in_degree_cap`` clamps each
    node to its strongest in-edges (:meth:`ShardedGraphCSR.partition`)."""
    from connectome_gnn_tpu_torch.models.node_coo import BlockedNodeSAGE

    csr = ShardedGraphCSR.partition(graph, num_shards, in_degree_cap=in_degree_cap,
                                    device=card_by_default(device, "graph_sharded_sage"))
    inner = BlockedNodeSAGE(in_channels=graph.num_features, hidden_dim=hidden_dim,
                            num_classes=num_classes, num_layers=num_layers)
    return GraphShardedSampledModel(csr, inner.to(csr.device), fanout, compaction=compaction)
