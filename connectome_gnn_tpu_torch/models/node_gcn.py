"""Node-level GCN over a banded giant graph (single device).

The port of ``connectome_gnn_tpu/models/node_gcn.py``: a spatially ordered
(or RCM-reordered) giant connectome in banded block-dense form, L
symmetric-normalized GCN convolutions over the band, masked BatchNorm,
ReLU and dropout per layer, and a per-node linear head.

Serving runs on an int8 band (:meth:`BandedNodeGCN.prepare_quantized`,
:meth:`BandedNodeGCN.apply_quantized`) through the hand-written kernels of
:mod:`connectome_gnn_tpu_torch.ops.banded_quant`: K4 by default, K5 with
``w8a8``, K3 for row-major and hybrid adjacencies.  Training runs on it too
(:meth:`BandedNodeGCN.prepare_quant_trainable`, then
:meth:`BandedNodeGCN.apply_quant_trainable` through K4 both ways, or
:meth:`BandedNodeGCN.apply_quant_trainable_blocked` through K6 both ways);
float32 training runs through :meth:`BandedNodeGCN.forward` or
:meth:`BandedNodeGCN.apply_normalized`.  Parameter names follow the port's
convention: ``convs.{i}.linear.weight``, ``convs.{i}.bias``,
``batch_norms.{i}.*``, ``head.weight``, ``head.bias``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from connectome_gnn_tpu_torch.models.layers import GCNConv
from connectome_gnn_tpu_torch.nn.layers import Dense, MaskedBatchNorm
from connectome_gnn_tpu_torch.ops.banded import (
    HybridMatrix,
    banded_spmm,
    gcn_normalize_banded,
    gcn_normalize_hybrid,
    hybrid_spmm,
)
from connectome_gnn_tpu_torch.ops.banded_quant import (
    QuantizedBandedMatrixFM,
    banded_spmm_quant_blocked_grad,
    banded_spmm_quant_fm_grad,
    quantize_band,
    quantize_hybrid,
    serving_spmm,
    to_feature_major,
    transposed_feature_major,
)


def require_eval(model: nn.Module) -> None:
    if model.training:
        raise ValueError("quantized serving is an eval-mode path; call model.eval() first")


class BandedNodeGCN(nn.Module):
    """L-layer node-classification GCN over a :class:`BandedMatrix` or a
    :class:`HybridMatrix`.  Train or eval mode is the module's own."""

    def __init__(
        self,
        in_channels: int,
        hidden_dim: int = 64,
        num_classes: int = 2,
        num_layers: int = 3,
        dropout: float = 0.0,
        *,
        generator: Optional[torch.Generator] = None,
    ):
        """Weights are drawn from ``generator`` (default: a fresh generator
        seeded 0): conv layers in order, then the head."""
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.in_channels = int(in_channels)
        self.hidden_dim = int(hidden_dim)
        self.num_classes = int(num_classes)
        self.num_layers = int(num_layers)
        dims = [self.in_channels] + [self.hidden_dim] * self.num_layers
        self.convs = nn.ModuleList(
            GCNConv(dims[i], dims[i + 1], generator=generator) for i in range(self.num_layers)
        )
        self.batch_norms = nn.ModuleList(
            MaskedBatchNorm(self.hidden_dim) for _ in range(self.num_layers)
        )
        self.head = Dense(self.hidden_dim, self.num_classes, generator=generator)
        self.dropout = nn.Dropout(dropout)

    def forward(self, adjacency, x: torch.Tensor, *, node_mask=None) -> torch.Tensor:
        """Per-node logits ``[num_nodes, C]`` in float32, normalizing the
        adjacency on every call (identical numerics for a pure band and a
        hybrid)."""
        return self.apply_normalized(*self.prepare(adjacency), x, node_mask=node_mask)

    @torch.no_grad()
    def prepare(self, adjacency, *, band_dtype: str = "float32"):
        """One-time setup: GCN-normalize the adjacency.  Returns
        ``(adj_norm, dinv)`` for :meth:`apply_normalized`.
        ``band_dtype="bfloat16"`` (pure bands) stores the normalized band
        in half the bytes; :func:`banded_spmm` widens it per diagonal."""
        if isinstance(adjacency, HybridMatrix):
            if band_dtype != "float32":
                raise ValueError(
                    "band_dtype is a pure-band option (the hybrid remainder path is f32)"
                )
            return gcn_normalize_hybrid(adjacency)
        if band_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"band_dtype must be float32/bfloat16, got {band_dtype!r}")
        adj_norm, dinv = gcn_normalize_banded(adjacency)
        if band_dtype == "bfloat16":
            adj_norm = adj_norm._replace(band=adj_norm.band.to(torch.bfloat16))
        return adj_norm, dinv

    def apply_normalized(self, adj_norm, dinv, x, *, node_mask=None) -> torch.Tensor:
        """:meth:`forward` over a :meth:`prepare`-d adjacency."""
        spmm = hybrid_spmm if isinstance(adj_norm, HybridMatrix) else banded_spmm
        return self._forward(spmm, adj_norm, dinv, x, node_mask)

    @torch.no_grad()
    def prepare_quantized(self, adjacency, feature_major: bool = True):
        """One-time serving setup: GCN-normalize, then int8-quantize the
        normalized band per tile.  Returns ``(adj_q, dinv)`` for
        :meth:`apply_quantized`.  ``feature_major`` (pure bands) stores the
        tiles transposed for K4/K5; hybrid adjacencies stay row-major (the
        scatter remainder wants node-major rows)."""
        if isinstance(adjacency, HybridMatrix):
            adj_norm, dinv = gcn_normalize_hybrid(adjacency)
            return quantize_hybrid(adj_norm), dinv
        adj_norm, dinv = gcn_normalize_banded(adjacency)
        q = quantize_band(adj_norm)
        return (to_feature_major(q) if feature_major else q), dinv

    @torch.no_grad()
    def apply_quantized(
        self, adj_q, dinv, x, *, node_mask=None, w8a8: bool = False, plain: bool = False
    ) -> torch.Tensor:
        """Eval-mode logits ``[num_nodes, C]`` over a
        :meth:`prepare_quantized` adjacency; BatchNorm uses its running
        moments and the model must be in eval mode.

        A feature-major adjacency keeps activations ``[F, N]`` across
        layers and runs K4, or K5 with ``w8a8`` (int8 activations; a
        row-major adjacency then raises ``ValueError``).  Row-major and
        hybrid adjacencies run K3.  ``plain=True`` runs the kernels' plain
        PyTorch versions instead, on any device.
        """
        require_eval(self)
        spmm = serving_spmm(adj_q, w8a8=w8a8, plain=plain)
        if isinstance(adj_q, QuantizedBandedMatrixFM):
            return self._forward_quant_fm(spmm, adj_q, dinv, x)
        return self._forward(spmm, adj_q, dinv, x, node_mask)

    @torch.no_grad()
    def prepare_quant_trainable(self, adjacency):
        """One-time setup for int8-band training: GCN-normalize, quantize
        the band once, and lay it out feature-major twice: as the forward
        operand and, transposed, as the backward one (``x̄ = Aᵀ·ȳ``).
        Returns ``(adj_q, adj_qT, dinv)`` for :meth:`apply_quant_trainable`
        and :meth:`apply_quant_trainable_blocked`.  Pure bands only: a
        :class:`HybridMatrix` raises ``ValueError``."""
        if isinstance(adjacency, HybridMatrix):
            raise ValueError(
                "quantized training supports pure bands; hybrid graphs train through "
                "forward/apply_normalized (f32)"
            )
        adj_norm, dinv = gcn_normalize_banded(adjacency)
        q_row = quantize_band(adj_norm)
        del adj_norm
        return to_feature_major(q_row), transposed_feature_major(q_row), dinv

    def apply_quant_trainable(
        self, adj_q, adj_qT, dinv, x, *, node_mask=None, plain: bool = False
    ) -> torch.Tensor:
        """Differentiable int8-band forward, feature-major end to end:
        logits ``[num_nodes, C]`` over a :meth:`prepare_quant_trainable`
        adjacency, in the module's mode (train-mode BatchNorm updates its
        running moments in place).  The band SpMM runs K4 forward and K4
        over ``adj_qT`` backward; ``plain=True`` runs their plain versions
        on any device.  In eval mode it equals :meth:`apply_quantized`."""
        spmm = lambda q, hT: banded_spmm_quant_fm_grad(q, adj_qT, hT, plain=plain)  # noqa: E731
        return self._forward_quant_fm(spmm, adj_q, dinv, x, node_mask)

    def apply_quant_trainable_blocked(
        self, adj_q, adj_qT, dinv, x, *, node_mask=None, plain: bool = False
    ) -> torch.Tensor:
        """:meth:`apply_quant_trainable` with blocked activations
        ``[NB, F, block]`` kept between layers; every band pass, forward
        and backward, runs K6.  ``x`` is node-major ``[N, F]`` or
        pre-blocked ``[NB, F, block]``; ``node_mask`` is ``[num_nodes]``
        or ``[NB·block]`` (default: the real nodes).  Logits
        ``[num_nodes, C]``; the same numbers as the feature-major path up
        to the order of float32 sums."""
        n, block, nb = adj_q.num_nodes, adj_q.block, adj_q.num_blocks
        padded = nb * block
        if x.dim() == 2:
            xp = x.new_zeros((padded, x.shape[1]), dtype=torch.float32)
            xp[:n] = x[:n]
            hb = xp.view(nb, block, -1).transpose(1, 2)
        else:
            hb = x
        self_norm_b = (dinv * dinv)[:padded].view(nb, 1, block)
        mask = torch.zeros(padded, dtype=torch.bool, device=dinv.device)
        if node_mask is None:
            mask[:n] = True
        else:
            mask[: node_mask.shape[0]] = node_mask[:padded]
        mask_b = mask.view(nb, block)
        for conv, norm in zip(self.convs, self.batch_norms):
            hwb = conv.linear.weight @ hb
            hb = (banded_spmm_quant_blocked_grad(adj_q, adj_qT, hwb, plain=plain)
                  + self_norm_b * hwb + conv.bias[None, :, None])
            hb = self.dropout(torch.relu(norm.forward_blocked(hb, mask_b)))
        logits_b = self.head.weight @ hb
        if self.head.bias is not None:
            logits_b = logits_b + self.head.bias[None, :, None]
        return logits_b.transpose(1, 2).reshape(padded, -1)[:n]

    def _forward_quant_fm(self, spmm, adj_q, dinv, x, node_mask=None) -> torch.Tensor:
        """Layout-persistent int8-band forward, shared by serving and
        training: activations stay feature-major across layers; only the
        input and the logits transpose."""
        n = adj_q.num_nodes
        self_normT = (dinv * dinv)[None, :n]
        hT = x[:n].T
        for conv, norm in zip(self.convs, self.batch_norms):
            hwT = conv.linear.weight @ hT
            hT = spmm(adj_q, hwT) + self_normT * hwT + conv.bias[:, None]
            hT = self.dropout(torch.relu(norm.forward_fm(hT, node_mask)))
        logitsT = self.head.weight @ hT
        if self.head.bias is not None:
            logitsT = logitsT + self.head.bias[:, None]
        return logitsT.T

    def _forward(self, spmm, adj_norm, dinv, x, node_mask) -> torch.Tensor:
        n = adj_norm.num_nodes
        if node_mask is None:
            node_mask = torch.ones(n, dtype=torch.bool, device=x.device)
        self_norm = (dinv * dinv)[:n, None]
        h = x[:n]
        for conv, norm in zip(self.convs, self.batch_norms):
            hw = conv.linear(h)
            h = spmm(adj_norm, hw) + self_norm * hw + conv.bias
            h = self.dropout(torch.relu(norm(h, node_mask)))
        return self.head(h)
