"""Fused whole-model eval forwards: K1 (GCN) and K2 (GraphSAGE).

Each runs an entire eval-mode :class:`GCNConnectome` or
:class:`GraphSAGEConnectome` on a dense ``[B, n, n]`` batch in one launch
of a hand-written CUDA kernel (``csrc/fused_forward.cu``), the port of the
Pallas kernels in ``connectome_gnn_tpu/ops/fused_pallas.py``.

Beside each kernel sit its plain PyTorch version
(:func:`fused_gcn_forward_reference`, :func:`fused_sage_forward_reference`)
and a launch counter (``fused_gcn_kernel.launches``,
``fused_sage_kernel.launches``, plain integers that grow by one per
launch).  :func:`fused_gcn_forward` and :func:`fused_sage_forward` take the
plain version for CPU tensors only; for a CUDA tensor they launch the
kernel or raise.

Eval-mode BatchNorm and the conv bias fold into one affine per layer,
computed host-side in torch as in the JAX package:

    BN(z + b_conv) = z * s' + t',   s' = scale / sqrt(var + eps)
                                    t' = (b_conv - mean) * s' + bias

SAGE's bias sits inside its ReLU, so it stays separate there.

At small batch a graph spans a thread-block cluster of :func:`cluster_size`
CTAs, each owning whole 16-row tiles of its receivers; the rule reads the
batch and the card's SM count and has no user setting.  The kernels' shared
memory layout lives in the CUDA source alone (``make_layout``): the C
entries size their own, and it never exceeds the routing rule's count
(:func:`smem_bytes`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from connectome_gnn_tpu_torch.data.dense import DenseConnectomeBatch
from connectome_gnn_tpu_torch.models.connectome import GCNConnectome, GraphSAGEConnectome

EPS = 1e-8

#: shared memory one thread block may hold on sm_90 (227 KB)
SMEM_LIMIT_BYTES = 232_448
#: rows of z staged per step in the first design's K2 (its byte count)
SAGE_CHUNK_ROWS = 16
#: largest padded graph that forward_auto routes to the kernels
MAX_FUSED_NODES = 128
#: rows of an m16 tile: a CTA of a cluster owns whole tiles of receivers
TILE_ROWS = 16
#: CTAs a graph's cluster may span: the portable cluster size (kMaxCluster)
MAX_CLUSTER = 8
#: thread blocks a batch may fill per SM before clusters stop paying
BLOCKS_PER_SM = 2


class GCNWeights(NamedTuple):
    """K1's operands, kernels in ``[in, out]`` layout (C argument order)."""

    w_in: torch.Tensor     # [F, H]
    w_h: torch.Tensor      # [L-1, H, H]
    scale: torch.Tensor    # [L, H]  folded BN+bias affine
    shift: torch.Tensor    # [L, H]
    w1: torch.Tensor       # [H, H2]
    b1: torch.Tensor       # [H2]
    w2: torch.Tensor       # [H2, C]
    b2: torch.Tensor       # [C]


class SAGEWeights(NamedTuple):
    """K2's operands, kernels in ``[in, out]`` layout (C argument order)."""

    w_self_in: torch.Tensor  # [F, H]
    w_agg_in: torch.Tensor   # [F, H]
    w_self_h: torch.Tensor   # [L-1, H, H]
    w_agg_h: torch.Tensor    # [L-1, H, H]
    bias: torch.Tensor       # [L, H]  conv bias (inside the ReLU)
    scale: torch.Tensor      # [L, H]  eval-BN affine (after the ReLU)
    shift: torch.Tensor      # [L, H]
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor


# ---------------------------------------------------------------------------
# Host-side weight preparation
# ---------------------------------------------------------------------------


@torch.no_grad()
def fold_bn_affine(model, *, include_conv_bias: bool = True):
    """Fold eval-mode BatchNorm (and, for GCN, the conv bias) into per-layer
    ``(scale [L, H], shift [L, H])``."""
    scales, shifts = [], []
    for conv, bn in zip(model.convs, model.batch_norms):
        s = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
        pre = conv.bias if include_conv_bias else 0.0
        scales.append(s)
        shifts.append((pre - bn.running_mean) * s + bn.bias)
    return torch.stack(scales), torch.stack(shifts)


def uniform_hidden_width(model) -> bool:
    """Whether every post-input conv is ``H → H`` (``2H → H`` for SAGE's
    concat kernel), the weight-stacking precondition of both kernels."""
    mult = 2 if isinstance(model, GraphSAGEConnectome) else 1
    H = model.convs[-1].linear.weight.shape[0]
    return all(
        tuple(conv.linear.weight.shape) == (H, mult * H) for conv in model.convs[1:]
    )


def _head(model):
    fc1, fc2 = model.classifier[0], model.classifier[3]
    return (
        fc1.weight.detach().t().contiguous(), fc1.bias.detach(),
        fc2.weight.detach().t().contiguous(), fc2.bias.detach(),
    )


def _stack(kernels, H, like):
    if kernels:
        return torch.stack(kernels).contiguous()
    return like.new_empty((0, H, H))  # L = 1: no hidden layers, no dummy slab


@torch.no_grad()
def gcn_weights(model: GCNConnectome) -> GCNWeights:
    """Fold and stack a GCN's weights for K1; raises ``ValueError`` on a
    non-uniform hidden width."""
    if not uniform_hidden_width(model):
        raise ValueError("fused kernel requires uniform hidden width across layers")
    kernels = [conv.linear.weight.detach().t() for conv in model.convs]
    H = kernels[0].shape[1]
    scale, shift = fold_bn_affine(model)
    return GCNWeights(
        kernels[0].contiguous(), _stack(kernels[1:], H, kernels[0]),
        scale, shift, *_head(model),
    )


@torch.no_grad()
def sage_weights(model: GraphSAGEConnectome) -> SAGEWeights:
    """Split, fold and stack a SAGE model's weights for K2; raises
    ``ValueError`` on a non-uniform hidden width."""
    if not uniform_hidden_width(model):
        raise ValueError("fused kernel requires uniform hidden width across layers")
    kernels = [conv.linear.weight.detach().t() for conv in model.convs]  # [2D, H]
    F = model.convs[0].linear.weight.shape[1] // 2
    H = kernels[0].shape[1]
    scale, shift = fold_bn_affine(model, include_conv_bias=False)
    return SAGEWeights(
        kernels[0][:F].contiguous(),
        kernels[0][F:].contiguous(),
        _stack([k[:H] for k in kernels[1:]], H, kernels[0]),
        _stack([k[H:] for k in kernels[1:]], H, kernels[0]),
        torch.stack([conv.linear.bias for conv in model.convs]),
        scale, shift, *_head(model),
    )


def smem_bytes(kind: str, n: int, F: int, H: int, H2: int) -> int:
    """The routing rule's shared memory for one graph of K1 (``kind="gcn"``)
    or K2 (``"sage"``): the first design's layout, f32 rows unpadded.  The
    kernels' own layout (``make_layout`` in the CUDA source, reported by
    ``cgt_fused_smem_bytes``) pads its strides only where that still fits
    one block, and otherwise takes no more than this count, so every shape
    this admits runs."""
    D = max(F, H)
    if kind == "gcn":
        floats = n * n + n * D + n * H + 2 * n + H + H2
    else:
        floats = n * n + 2 * n * D + SAGE_CHUNK_ROWS * H + 2 * n + H + H2
    return 4 * floats


def cluster_size(B: int, n: int, sm_count: int) -> int:
    """CTAs a graph spans: the largest ``cs <= min(8, ceil(n / 16))`` with
    ``B * cs <= 2 * sm_count``, else 1.  At n = 88 on 132 SMs: 6 up to 44
    graphs, 1 from 133 on."""
    fit = BLOCKS_PER_SM * sm_count // B if B else MAX_CLUSTER
    return max(1, min(MAX_CLUSTER, -(-n // TILE_ROWS), fit))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _pool_and_head(h, node_mask, w):
    m = node_mask.to(h.dtype)[:, :, None]
    pooled = (h * m).sum(dim=1) / (m.sum(dim=1) + EPS)
    hidden = torch.relu(torch.matmul(pooled, w.w1) + w.b1)
    return torch.matmul(hidden, w.w2) + w.b2


def fused_gcn_forward_reference(x, adj, node_mask, w: GCNWeights) -> torch.Tensor:
    """K1's math in plain torch: logits ``[B, C]``."""
    deg = adj.sum(dim=1) + 1.0  # column sums: sender degrees
    dinv = torch.rsqrt(deg + EPS)
    adj_n = dinv[:, :, None] * adj * dinv[:, None, :]
    self_n = (dinv * dinv)[:, :, None]
    h = x
    for layer in range(w.scale.shape[0]):
        W = w.w_in if layer == 0 else w.w_h[layer - 1]
        hw = torch.matmul(h, W)
        agg = torch.einsum("bij,bjo->bio", adj_n, hw) + self_n * hw
        h = torch.relu(agg * w.scale[layer] + w.shift[layer])
    return _pool_and_head(h, node_mask, w)


def fused_sage_forward_reference(x, adj, node_mask, w: SAGEWeights) -> torch.Tensor:
    """K2's math in plain torch: logits ``[B, C]``."""
    w_sum = adj.sum(dim=2, keepdim=True) + EPS  # row sums: receiver weights
    h = x
    for layer in range(w.scale.shape[0]):
        Ws = w.w_self_in if layer == 0 else w.w_self_h[layer - 1]
        Wa = w.w_agg_in if layer == 0 else w.w_agg_h[layer - 1]
        agg = torch.einsum("bij,bjd->bid", adj, h) / w_sum
        z = torch.matmul(h, Ws) + torch.matmul(agg, Wa) + w.bias[layer]
        h = torch.relu(z) * w.scale[layer] + w.shift[layer]
    return _pool_and_head(h, node_mask, w)


# ---------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------


def _launch(kind, entry, x, adj, node_mask, w) -> torch.Tensor:
    """Check the operands, launch one kernel on the current stream with
    :func:`cluster_size` CTAs a graph, raise on a refused launch (no retry
    with another cluster size).  Returns logits ``[B, C]``."""
    if x.device.type != "cuda":
        raise ValueError(f"the fused {kind} kernel needs CUDA tensors, got {x.device}")
    B, n, F = x.shape
    H, H2, C, L = w.scale.shape[1], w.w1.shape[1], w.w2.shape[1], w.scale.shape[0]
    if tuple(adj.shape) != (B, n, n) or tuple(node_mask.shape) != (B, n):
        raise ValueError(
            f"shapes x {tuple(x.shape)}, adj {tuple(adj.shape)}, "
            f"mask {tuple(node_mask.shape)} do not form one [B, n] batch"
        )
    if node_mask.dtype != torch.bool:
        raise ValueError(f"node_mask must be bool, got {node_mask.dtype}")
    for name, t in (("x", x), ("adj", adj), *zip(w._fields, w)):
        if t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {x.device}")
    if not node_mask.is_contiguous() or node_mask.device != x.device:
        raise ValueError(f"node_mask must be contiguous on {x.device}")
    nbytes = smem_bytes(kind, n, F, H, H2)
    if nbytes > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"fused {kind} kernel: n={n}, F={F}, H={H} needs {nbytes} bytes of "
            f"shared memory per block, more than {SMEM_LIMIT_BYTES}"
        )
    out = torch.empty((B, C), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    from connectome_gnn_tpu_torch.ops._build import library

    lib = library()
    cs = cluster_size(B, n, _sm_count(x.device.index))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, entry)(
            *(t.data_ptr() for t in (x, adj, node_mask, *w, out)), B, n, F, H, H2, C, L, cs, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"fused {kind} kernel launch failed: {lib.cgt_error_string(err).decode()}"
        )
    return out


def fused_gcn_kernel(x, adj, node_mask, w: GCNWeights) -> torch.Tensor:
    """Launch K1 on CUDA tensors; logits ``[B, C]``."""
    out = _launch("gcn", "cgt_fused_gcn_forward", x, adj, node_mask, w)
    fused_gcn_kernel.launches += 1
    return out


def fused_sage_kernel(x, adj, node_mask, w: SAGEWeights) -> torch.Tensor:
    """Launch K2 on CUDA tensors; logits ``[B, C]``."""
    out = _launch("sage", "cgt_fused_sage_forward", x, adj, node_mask, w)
    fused_sage_kernel.launches += 1
    return out


fused_gcn_kernel.launches = 0
fused_sage_kernel.launches = 0


# ---------------------------------------------------------------------------
# Model-level entry points
# ---------------------------------------------------------------------------


def fused_gcn_forward(model: GCNConnectome, x, adj, node_mask) -> torch.Tensor:
    """Eval-mode GCN logits ``[B, C]`` over a dense batch: K1 on CUDA
    tensors, its plain version on CPU tensors."""
    w = gcn_weights(model)
    if x.device.type == "cpu":
        return fused_gcn_forward_reference(x, adj, node_mask, w)
    return fused_gcn_kernel(x, adj, node_mask, w)


def fused_sage_forward(model: GraphSAGEConnectome, x, adj, node_mask) -> torch.Tensor:
    """Eval-mode GraphSAGE logits ``[B, C]`` over a dense batch: K2 on CUDA
    tensors, its plain version on CPU tensors."""
    w = sage_weights(model)
    if x.device.type == "cpu":
        return fused_sage_forward_reference(x, adj, node_mask, w)
    return fused_sage_kernel(x, adj, node_mask, w)


def forward_auto(model, batch) -> torch.Tensor:
    """Eval-mode logits, through the fused kernel where the batch fits it.

    The rule, checked before any launch: the model is a
    :class:`GCNConnectome` (→ K1) or :class:`GraphSAGEConnectome` (→ K2),
    the batch is a :class:`DenseConnectomeBatch` with ``n ≤ 128`` padded
    nodes, every post-input layer has the uniform hidden width, the
    kernel's shared memory (:func:`smem_bytes`) fits one block, and the
    batch lies on a CUDA device.  Every other batch runs ``model(batch)``.
    The model must be in eval mode.

    The rule does not read ``compute_dtype``, as JAX's ``forward_auto``
    (``connectome_gnn_tpu/ops/fused_pallas.py:264-305``) does not: a
    bfloat16 model that fits is served in float32 by K1/K2.
    """
    if model.training:
        raise ValueError("forward_auto is an eval-mode path; call model.eval() first")
    if isinstance(model, GCNConnectome):
        kind, fused = "gcn", fused_gcn_forward
    elif isinstance(model, GraphSAGEConnectome):
        kind, fused = "sage", fused_sage_forward
    else:
        return model(batch)
    H = model.convs[-1].linear.weight.shape[0]
    H2 = model.classifier[0].weight.shape[0]
    if (
        isinstance(batch, DenseConnectomeBatch)
        and batch.num_nodes <= MAX_FUSED_NODES
        and uniform_hidden_width(model)
        and smem_bytes(kind, batch.num_nodes, batch.num_features, H, H2) <= SMEM_LIMIT_BYTES
        and batch.adj.is_cuda
    ):
        return fused(model, batch.node_features, batch.adj, batch.node_mask)
    return model(batch)
