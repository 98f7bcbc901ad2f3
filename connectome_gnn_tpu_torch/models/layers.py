"""Message-passing layers: GCN and GraphSAGE convolutions.

Each layer takes the padded COO batch layout (:meth:`forward`), the dense
receiver-major ``[B, n, n]`` adjacency (:meth:`forward_dense`) or the
device sampler's per-hop ``[frontier, fanout]`` blocks
(:meth:`forward_blocked`), with the same numerics up to the order of
float32 sums.  Numeric contract (reference
``connectome_gnn/models.py``, as in ``connectome_gnn_tpu.models.layers``):

* :class:`GCNConv`: ``H' = D̂^{-1/2} Â D̂^{-1/2} (H W) + b`` with self-loop
  weight 1.0, Xavier-uniform kernel, zero bias added after aggregation.
* :class:`SAGEConv`: weighted-mean neighbour aggregation, concat with the
  self features, one linear + ReLU; Xavier kernel, torch-default bias, no
  self-loops.

Both use the ``+1e-8`` epsilon denominators of the reference.  Parameter
names follow the reference's ``state_dict`` (``linear.weight``, GCN
``bias``, SAGE ``linear.bias``).

Mixed precision (``compute_dtype=torch.bfloat16``, dense layout only, as in
``connectome_gnn_tpu/models/layers.py:228-281``): each matmul's operands are
rounded to bfloat16 and the exact products are summed in float32
(:func:`mixed_matmul`); degrees, normalization and the output stay float32.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from connectome_gnn_tpu_torch.nn.initializers import xavier_uniform
from connectome_gnn_tpu_torch.nn.layers import Dense
from connectome_gnn_tpu_torch.ops.gcn_norm import gcn_normalize
from connectome_gnn_tpu_torch.ops.segment import coo_spmm, segment_sum

EPS = 1e-8
#: the matmul operand types of the dense path
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 (to nearest, ties to even, as JAX's
    ``astype(jnp.bfloat16)``), held in float32."""
    return t.to(torch.bfloat16).to(torch.float32)


@contextlib.contextmanager
def exact_products():
    """cuBLAS products inside take every operand bit and sum in float32:
    TF32 and bfloat16 reduced-precision reduction are switched off, and
    the caller's flags restored after."""
    flags = torch.backends.cuda.matmul
    saved = flags.allow_tf32, flags.allow_bf16_reduced_precision_reduction
    flags.allow_tf32 = False
    flags.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        flags.allow_tf32, flags.allow_bf16_reduced_precision_reduction = saved


def mixed_matmul(a: torch.Tensor, b: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
    """``a @ b`` in float32, its operands first rounded to ``compute_dtype``.

    At ``torch.float32`` the plain product.  At ``torch.bfloat16`` JAX's
    ``dot(a.astype(bf16), b.astype(bf16), preferred_element_type=f32)``:
    the product of two bfloat16 values is exact in float32, so the result
    is the float32 sum of exact products, in float32 (a bfloat16 output
    would round it a second time).  ``b`` is ``[K, N]`` (``a [..., K]``)
    or ``[B, K, N]`` (``a [B, M, K]``).  On every device the operands are
    rounded and multiplied in float32 under :func:`exact_products`,
    backward too (:class:`_ExactProduct`).
    """
    if compute_dtype == torch.float32:
        return torch.matmul(a, b)
    if compute_dtype != torch.bfloat16:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, got {compute_dtype}")
    return _ExactProduct.apply(round_bf16(a), round_bf16(b))


class _ExactProduct(torch.autograd.Function):
    """``a @ b`` with its forward and backward products under
    :func:`exact_products`: autograd runs the backward outside the
    caller's scope, where the flags may be on."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(a, b)
        with exact_products():
            return torch.matmul(a, b)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        a, b = ctx.saved_tensors
        grad_a = grad_b = None
        with exact_products():
            if ctx.needs_input_grad[0]:
                grad_a = torch.matmul(grad, b.transpose(-1, -2))
            if ctx.needs_input_grad[1]:
                if b.dim() == 2:
                    grad_b = a.reshape(-1, a.shape[-1]).t() @ grad.reshape(-1, grad.shape[-1])
                else:
                    grad_b = torch.matmul(a.transpose(-1, -2), grad)
        return grad_a, grad_b


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` for an index of any shape, through ``index_select``,
    whose backward on the CPU sums in a fixed order (``coo_spmm``'s note)."""
    return x.index_select(0, idx.reshape(-1)).view(*idx.shape, *x.shape[1:])


def add_rows(out: torch.Tensor, rows: torch.Tensor, start, idx: torch.Tensor) -> torch.Tensor:
    """``out`` with ``rows`` added at rows ``start, start + 1, ...`` (a
    contiguous run, when ``start`` is an int) or at rows ``idx``
    (duplicates add up), out of place."""
    if start is None:
        return out.index_add(0, idx, rows)
    stop = start + rows.shape[0]
    return torch.cat([out[:start], out[start:stop] + rows, out[stop:]])


def dense_apply(layer: Dense, x: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
    """``layer(x)`` with its product at ``compute_dtype``."""
    if compute_dtype == torch.float32:
        return layer(x)
    y = mixed_matmul(x, layer.weight.t(), compute_dtype)
    return y if layer.bias is None else y + layer.bias


class GCNConv(nn.Module):
    """Symmetric-normalized weighted graph convolution."""

    def __init__(self, in_channels: int, out_channels: int, *, generator: torch.Generator):
        super().__init__()
        self.linear = Dense(
            in_channels, out_channels, generator=generator, bias=False,
            kernel_init=xavier_uniform,
        )
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(
        self,
        x: torch.Tensor,
        senders: torch.Tensor,
        receivers: torch.Tensor,
        edge_weight: torch.Tensor,
    ) -> torch.Tensor:
        """COO layout: transform, then gather-scale-segment-sum, with the
        self-loop block as an elementwise rescale."""
        num_nodes = x.shape[0]
        norm = gcn_normalize(senders, receivers, edge_weight, num_nodes)
        xw = self.linear(x)
        out = coo_spmm(norm.edge_norm, senders, receivers, xw, num_nodes)
        out = out + norm.self_norm[:, None] * xw
        return out + self.bias

    def forward_blocked(self, x: torch.Tensor, hop_blocks, num_seeds: int) -> torch.Tensor:
        """:meth:`forward` over the device sampler's per-hop ``[frontier,
        fanout]`` blocks (``gcn_layer_apply_blocked``,
        ``connectome_gnn_tpu/models/layers.py:75``): the same math up to
        the order of float32 sums, with fewer random-access passes.

        Every hop's receivers are constant along a block row, so the
        aggregation is a sum over each row plus a frontier-count scatter;
        hop 0's receivers are ``arange(num_seeds)``, so it lands by a slice.
        Only the sender-side gathers stay at edge count.
        """
        num_nodes = x.shape[0]
        senders = torch.cat([b.senders.reshape(-1) for b in hop_blocks])
        weights = torch.cat([b.weights.reshape(-1) for b in hop_blocks])
        deg = segment_sum(weights, senders, num_nodes) + 1.0
        dis = torch.rsqrt(deg + EPS)
        xw = self.linear(x)
        out = (dis * dis)[:, None] * xw  # the self-loop term (weight 1.0)
        for h, b in enumerate(hop_blocks):
            recv_dis = dis[:num_seeds] if h == 0 else dis[b.recv]
            e = dis[b.senders] * b.weights * recv_dis[:, None]  # [Fb, f]
            part = torch.einsum("bf,bfc->bc", e, gather_rows(xw, b.senders))
            out = add_rows(out, part, 0 if h == 0 else None, b.recv)
        return out + self.bias

    def forward_dense(
        self, x: torch.Tensor, adj: torch.Tensor, compute_dtype=torch.float32
    ) -> torch.Tensor:
        """Dense layout ``x [B, n, F]``, ``adj [B, n, n]``.  The degree of
        sender j is the column sum over receivers i, plus the self-loop.
        ``compute_dtype`` rounds the operands of ``x·W`` and
        ``adj_norm·xw``; degrees and the self-loop term stay float32."""
        deg = adj.sum(dim=1) + 1.0
        dinv = torch.rsqrt(deg + EPS)  # [B, n]
        adj_norm = dinv[:, :, None] * adj * dinv[:, None, :]
        xw = dense_apply(self.linear, x, compute_dtype)
        out = mixed_matmul(adj_norm, xw, compute_dtype) + (dinv * dinv)[:, :, None] * xw
        return out + self.bias


class SAGEConv(nn.Module):
    """Weighted-mean aggregate → concat(self, agg) → linear → ReLU."""

    def __init__(self, in_channels: int, out_channels: int, *, generator: torch.Generator):
        super().__init__()
        self.linear = Dense(
            2 * in_channels, out_channels, generator=generator,
            kernel_init=xavier_uniform,
        )

    def forward(
        self,
        x: torch.Tensor,
        senders: torch.Tensor,
        receivers: torch.Tensor,
        edge_weight: torch.Tensor,
    ) -> torch.Tensor:
        num_nodes = x.shape[0]
        msg_sum = coo_spmm(edge_weight, senders, receivers, x, num_nodes)
        w_sum = segment_sum(edge_weight[:, None], receivers, num_nodes)
        agg = msg_sum / (w_sum + EPS)
        return torch.relu(self.linear(torch.cat([x, agg], dim=1)))

    def forward_blocked(self, x: torch.Tensor, hop_blocks, num_seeds: int) -> torch.Tensor:
        """:meth:`forward` over the device sampler's per-hop ``[frontier,
        fanout]`` blocks (``sage_layer_apply_blocked``,
        ``connectome_gnn_tpu/models/layers.py:164``): the same math up to
        the order of float32 sums.

        Each local node receives edges in one hop only, the one whose
        frontier found it, so the weighted mean's numerator and denominator
        reduce along block rows and land by a frontier-count scatter; hop 0
        lands by a slice.  In the multiset mode the senders are a
        contiguous slice of ``x`` (an invalid draw reads its own zeroed slot,
        with weight 0) and the receivers a contiguous run of slots.
        """
        msg = torch.zeros_like(x)
        w_sum = x.new_zeros(x.shape[0])
        for h, b in enumerate(hop_blocks):
            Fb, f = b.weights.shape
            if b.sender_start is not None:
                xs = x[b.sender_start : b.sender_start + Fb * f].reshape(Fb, f, -1)
            else:
                xs = gather_rows(x, b.senders)
            part = torch.einsum("bf,bfc->bc", b.weights, xs)
            wrow = b.weights.sum(dim=1)
            start = 0 if h == 0 else b.recv_start
            msg = add_rows(msg, part, start, b.recv)
            w_sum = add_rows(w_sum, wrow, start, b.recv)
        agg = msg / (w_sum + EPS)[:, None]
        return torch.relu(self.linear(torch.cat([x, agg], dim=1)))

    def forward_dense(
        self, x: torch.Tensor, adj: torch.Tensor, compute_dtype=torch.float32
    ) -> torch.Tensor:
        """Dense layout: the weight sum is a row sum (receiver-major).
        ``compute_dtype`` rounds the operands of ``adj·x`` and
        ``concat·W``; the weight sum stays float32."""
        msg_sum = mixed_matmul(adj, x, compute_dtype)
        w_sum = adj.sum(dim=-1, keepdim=True)
        agg = msg_sum / (w_sum + EPS)
        return torch.relu(dense_apply(self.linear, torch.cat([x, agg], dim=-1), compute_dtype))
