"""The plain reference: the configurations' models in float32 PyTorch over
the COO edge list the benchmark generated, with no kernel, no band and
nothing of the program.

It works out again everything the program derives from the inputs: the
coalesced adjacency, GCN's symmetric normalization, the per-tile int8
quantization of the band's tiles, the SAGE mean's denominator, the device
sampler's draws and sample, and Adam.  Sums run over edge chunks so that a
million nodes and 40M edges fit beside a few GB.

Layer equations (Kipf & Welling, arXiv:1609.02907; Hamilton et al.,
arXiv:1706.02216), as the program's configuration states them:

- GCN: ``deg_s = Σ_{edges s→·} w + 1``, ``d = (deg + 1e-8)^-1/2``,
  ``h' = Σ_{s→r} d_r w d_s (hW)_s + d_r² (hW)_r + b``, then masked
  BatchNorm (biased batch variance, eps 1e-5), ReLU.
- SAGE: ``agg_r = Σ_{s→r} w h_s / (Σ_{s→r} w + 1e-8)``,
  ``h' = ReLU([h, agg] Wᵀ + b)``, then BatchNorm with no ReLU after it.
- A linear head on each node.

Precision: ``band_bits`` quantizes each normalized (GCN) or raw (SAGE)
adjacency entry per tile of ``block × block`` nodes, symmetric, ``scale =
maxabs · fl(1/qmax)``, ``qmax = 2^(bits-1) - 1``, round half to even;
``None`` leaves the adjacency float32.  ``tf32=True`` rounds every product's
operands to TF32 (10 mantissa bits): the control of float32 paths.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-8
BN_EPS = 1e-5
CHUNK = 1 << 22


@contextlib.contextmanager
def exact_float32():
    """TF32 off for every matmul the reference runs; restored after."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the nearest TF32 value (ties away from zero); the
    gradient passes through unchanged."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach() if x.requires_grad else rounded


class Adjacency:
    """A coalesced weighted adjacency: ``senders``, ``receivers`` (int64)
    and ``values`` (float32), duplicate edges summed."""

    def __init__(self, senders, receivers, values, num_nodes: int):
        self.senders, self.receivers, self.values = senders, receivers, values
        self.num_nodes = int(num_nodes)

    @classmethod
    def coalesce(cls, senders, receivers, weights, num_nodes: int) -> "Adjacency":
        key = receivers.long() * num_nodes + senders.long()
        uniq, inverse = torch.unique(key, return_inverse=True)
        values = torch.zeros(uniq.shape, dtype=torch.float32, device=weights.device)
        values.index_add_(0, inverse, weights.float())
        return cls(uniq % num_nodes, uniq // num_nodes, values, num_nodes)

    def with_values(self, values) -> "Adjacency":
        return Adjacency(self.senders, self.receivers, values, self.num_nodes)

    def sender_sum(self) -> torch.Tensor:
        return torch.zeros(self.num_nodes, device=self.values.device).index_add_(
            0, self.senders, self.values)

    def receiver_sum(self) -> torch.Tensor:
        return torch.zeros(self.num_nodes, device=self.values.device).index_add_(
            0, self.receivers, self.values)

    def quantized(self, block: int, bits: Optional[int]) -> "Adjacency":
        """Each entry rounded to ``bits`` by its tile's scale (see the
        module docstring); ``bits=None`` returns ``self``."""
        if bits is None:
            return self
        qmax = float(2 ** (bits - 1) - 1)
        rb, sb = self.receivers // block, self.senders // block
        width = int((sb - rb).abs().max()) if rb.numel() else 0
        tile = rb * (2 * width + 1) + (sb - rb + width)
        maxabs = torch.zeros(int(tile.max()) + 1 if tile.numel() else 1,
                             device=self.values.device)
        maxabs.scatter_reduce_(0, tile, self.values.abs(), reduce="amax")
        inv = torch.tensor(1.0 / qmax, dtype=torch.float32, device=self.values.device)
        scale = torch.where(maxabs > 0, maxabs * inv, torch.ones_like(maxabs))[tile]
        q = torch.div(self.values, scale).round().clamp(-qmax, qmax)
        return self.with_values(q * scale)

    def matmul(self, x: torch.Tensor, tf32: bool = False) -> torch.Tensor:
        """``A @ x`` (rows are receivers), differentiable in ``x``."""
        return _EdgeProduct.apply(x, self, tf32)


class _EdgeProduct(torch.autograd.Function):
    """``out[r] = Σ_{s→r} a · x[s]`` over edge chunks; the backward is the
    same product over the reversed edges."""

    @staticmethod
    def forward(ctx, x, adj: Adjacency, tf32: bool):
        ctx.adj, ctx.tf32 = adj, tf32
        return _scatter_product(x, adj.values, adj.senders, adj.receivers, adj.num_nodes, tf32)

    @staticmethod
    def backward(ctx, g):
        adj = ctx.adj
        return (_scatter_product(g, adj.values, adj.receivers, adj.senders, adj.num_nodes,
                                 ctx.tf32), None, None)


def _scatter_product(x, values, src, dst, num_nodes: int, tf32: bool) -> torch.Tensor:
    if tf32:
        x, values = round_tf32(x), round_tf32(values)
    out = x.new_zeros((num_nodes, x.shape[1]))
    for lo in range(0, values.numel(), CHUNK):
        hi = lo + CHUNK
        out.index_add_(0, dst[lo:hi], values[lo:hi, None] * x[src[lo:hi]])
    return out


def linear(x, weight, bias=None, tf32: bool = False) -> torch.Tensor:
    if tf32:
        x, weight = round_tf32(x), round_tf32(weight)
    return F.linear(x, weight, bias)


def norm_and_head_shapes(config: dict) -> dict:
    """Every layer's BatchNorm affine and moments, then the linear head,
    by the program's names."""
    h = config["hidden_dim"]
    shapes = {f"batch_norms.{i}.{k}": (h,) for i in range(config["num_layers"])
              for k in ("weight", "bias", "running_mean", "running_var")}
    c = config["num_classes"]
    return {**shapes, "head.weight": (c, h), "head.bias": (c,)}


def batch_norm(h, p: dict, i: int, train: bool) -> torch.Tensor:
    """Layer ``i``'s BatchNorm: the batch's moments (biased variance) in
    train mode, the running ones in eval mode."""
    bn = f"batch_norms.{i}."
    if train:
        mean, var = h.mean(0), h.var(0, unbiased=False)
    else:
        mean, var = p[bn + "running_mean"], p[bn + "running_var"]
    return (h - mean) * torch.rsqrt(var + BN_EPS) * p[bn + "weight"] + p[bn + "bias"]


def gcn_adjacency(adj: Adjacency, block: int, bits: Optional[int]):
    """GCN's normalized (and quantized) adjacency and ``d²`` for the
    self-loop term."""
    d = torch.rsqrt(adj.sender_sum() + 1.0 + EPS)
    norm = adj.with_values(d[adj.receivers] * adj.values * d[adj.senders])
    return norm.quantized(block, bits), d * d


def gcn_logits(p: dict, adj: Adjacency, self_norm, x, num_layers: int, *, train=True,
               tf32=False, out_rows=None) -> torch.Tensor:
    """GCN logits, read at ``out_rows`` (default: every node); in train mode
    BatchNorm takes the moments of every node of the batch, in eval mode
    its running ones."""
    h = x
    for i in range(num_layers):
        hw = linear(h, p[f"convs.{i}.linear.weight"], tf32=tf32)
        h = adj.matmul(hw, tf32) + self_norm[:, None] * hw + p[f"convs.{i}.bias"]
        h = torch.relu(batch_norm(h, p, i, train))
    if out_rows is not None:
        h = h[out_rows]
    return linear(h, p["head.weight"], p["head.bias"], tf32=tf32)


def sage_logits(p: dict, adj_q: Adjacency, w_sum, x, num_layers: int, *, train=False,
                tf32=False) -> torch.Tensor:
    """SAGE logits: the mean's numerator over ``adj_q`` and its denominator
    ``w_sum`` from the unquantized weights; BatchNorm as in
    :func:`gcn_logits`, with no ReLU after it."""
    h = x
    for i in range(num_layers):
        agg = adj_q.matmul(h, tf32) / (w_sum[:, None] + EPS)
        h = torch.relu(linear(torch.cat([h, agg], dim=1), p[f"convs.{i}.linear.weight"],
                              p[f"convs.{i}.linear.bias"], tf32=tf32))
        h = batch_norm(h, p, i, train)
    return linear(h, p["head.weight"], p["head.bias"], tf32=tf32)


def masked_cross_entropy(logits, labels, mask) -> torch.Tensor:
    ce = F.cross_entropy(logits, labels, reduction="none")
    m = mask.float()
    return (ce * m).sum() / m.sum().clamp(min=1.0)


class Adam:
    """Adam with L2 weight decay added to the gradient before the moments
    (lr 1e-3, betas 0.9 / 0.999, eps 1e-8, decay 1e-4)."""

    def __init__(self, params: dict, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4):
        self.lr, self.betas, self.eps, self.wd = lr, betas, eps, weight_decay
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> dict:
        """Updates ``params`` in place; returns the gradients it used
        (decay included)."""
        self.t += 1
        b1, b2 = self.betas
        used = {}
        for k, p in params.items():
            g = grads[k] + self.wd * p
            used[k] = g
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            m_hat = self.m[k] / (1 - b1 ** self.t)
            v_hat = self.v[k] / (1 - b2 ** self.t)
            p.sub_(self.lr * m_hat / (v_hat.sqrt() + self.eps))
        return used


def train_steps(params0: dict, trainable: Sequence[str], steps: int, loss_of) -> dict:
    """``steps`` Adam steps from ``params0`` on ``loss_of(params, step)``;
    returns each step's loss, the first step's gradients as Adam takes
    them, and each trainable leaf's change after the last step."""
    params = {k: v.detach().clone() for k, v in params0.items()}
    train = {k: params[k] for k in trainable}
    opt = Adam(train)
    losses, first = [], None
    for step in range(steps):
        leaves = {k: v.requires_grad_(True) for k, v in train.items()}
        loss = loss_of({**params, **leaves}, step)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        for v in leaves.values():
            v.requires_grad_(False)
        used = opt.step(train, dict(zip(leaves, grads)))
        if first is None:
            first = {k: g.clone() for k, g in used.items()}
        losses.append(float(loss.detach()))
    change = {k: train[k] - params0[k] for k in trainable}
    return {"losses": losses, "grads": first, "change": change}


# ---------------------------------------------------------------------------
# The device sampler's semantics: draws and sample
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    return (x * (c & 0x7FFFFFFF) + (((x & 1) << 31) if c >> 31 else 0)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """Wellons' lowbias32 on int64 values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def sample_key(base: int, epoch: int, step: int) -> int:
    """The sampling key of one (epoch, step) of a seed loader."""
    return int(np.random.SeedSequence([base, epoch, step, 0]).generate_state(1)[0] & 0x7FFFFFFF)


def hop_uniforms(key: int, hop: int, rows: int, width: int, device) -> torch.Tensor:
    """Uniforms ``[rows, width]`` in [0, 1), 24 bits, of a counter hash of
    the key ``(0, key)``, the hop and the slot."""
    lo = torch.tensor(key & _M32, dtype=torch.int64, device=device)
    stream = _mix32(_mix32(lo) ^ 0)
    stream = _mix32(stream ^ (((hop + 1) * _GOLDEN) & _M32))
    slots = torch.arange(rows * width, device=device)
    bits = _mix32(_mix32(slots ^ stream) ^ stream)
    return ((bits >> 8).float() * 2.0 ** -24).view(rows, width)


def sample_blocks(seeds: torch.Tensor, key: int, fanout: Sequence[int], degree: int,
                  senders: torch.Tensor):
    """Fanout sampling without replacement over a receiver-major edge list
    of ``degree`` in-edges a node (edge ``r·degree + j`` is node ``r``'s
    slot ``j``): each frontier row keeps the ``f`` slots with the largest
    draws (ties to the lower slot).  A hop's frontier is the nodes first
    found in the previous hop, in ascending id; row ``p`` of a hop's draws
    belongs to the node at position ``p`` of the sorted candidates that
    were new in the previous hop.  Returns the global ``(senders,
    receivers)`` of every sampled edge, its weight's edge ids, and the
    sampled node set (seeds first)."""
    device = seeds.device
    frontier = seeds
    rows = int(seeds.shape[0])
    known = seeds
    edge_ids, receivers = [], []
    for h, f in enumerate(fanout):
        u = hop_uniforms(key, h, rows, degree, device)
        valid = frontier >= 0
        pos = torch.sort(u[valid], dim=1, descending=True, stable=True).indices[:, :f]
        recv = frontier[valid]
        eid = recv[:, None] * degree + pos
        edge_ids.append(eid.reshape(-1))
        receivers.append(recv[:, None].expand(-1, f).reshape(-1))
        cand = senders[eid.reshape(-1)]
        fresh = torch.sort(cand[~torch.isin(cand, known)]).values
        rows = int(cand.numel())
        frontier = torch.full((rows,), -1, dtype=torch.long, device=device)
        if fresh.numel():
            first = torch.ones_like(fresh, dtype=torch.bool)
            first[1:] = fresh[1:] != fresh[:-1]
            where = torch.nonzero(first).squeeze(1)
            frontier[where] = fresh[first]
            known = torch.cat([known, fresh[first]])
    edge_ids = torch.cat(edge_ids)
    return senders[edge_ids], torch.cat(receivers), edge_ids, known


def sampled_gcn_loss(p: dict, seeds, key, fanout, degree, graph_senders, graph_weights,
                     features, labels, labelled, num_layers, *, tf32=False):
    """One sampled step's loss: the sample's subgraph (sampled edges only,
    its own sender degrees), GCN over every sampled node, the head at the
    seeds, the mean cross-entropy over the labelled seeds.  Returns the
    loss and the sample's ``(nodes, edges)``."""
    snd, rcv, eid, nodes = sample_blocks(seeds, key, fanout, degree, graph_senders)
    local = torch.full((features.shape[0],), -1, dtype=torch.long, device=seeds.device)
    local[nodes] = torch.arange(nodes.numel(), device=seeds.device)
    adj = Adjacency(local[snd], local[rcv], graph_weights[eid], nodes.numel())
    d = torch.rsqrt(adj.sender_sum() + 1.0 + EPS)
    norm = adj.with_values(d[adj.receivers] * adj.values * d[adj.senders])
    logits = gcn_logits(p, norm, d * d, features[nodes], num_layers, tf32=tf32,
                        out_rows=torch.arange(seeds.numel(), device=seeds.device))
    loss = masked_cross_entropy(logits, labels[seeds], labelled[seeds])
    return loss, (int(nodes.numel()), int(eid.numel()))
