"""Core building blocks: dense layer and masked BatchNorm.

Masked BatchNorm is why ``nn.BatchNorm1d`` cannot be used: batches are
padded to static shapes, and padded rows must stay out of the batch
moments or the statistics drift from the reference's unpadded ones.  The
module keeps ``nn.BatchNorm1d``'s parameter and buffer names (``weight``,
``bias``, ``running_mean``, ``running_var``, ``num_batches_tracked``), so a
reference checkpoint loads with ``load_state_dict``.  Dropout is
``nn.Dropout``, the identity in eval mode.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from connectome_gnn_tpu_torch.nn.initializers import (
    torch_linear_bias,
    torch_linear_kernel,
)


class Dense(nn.Module):
    """``x @ weight.T (+ bias)`` with ``weight [out, in]``, initialized from
    an explicit generator (default: PyTorch's ``nn.Linear`` recipe)."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        *,
        generator: torch.Generator,
        bias: bool = True,
        kernel_init=torch_linear_kernel,
        bias_init=torch_linear_bias,
    ):
        super().__init__()
        self.in_features = int(in_features)
        self.out_features = int(out_features)
        self.weight = nn.Parameter(kernel_init(in_features, out_features, generator))
        self.bias = (
            nn.Parameter(bias_init(in_features, out_features, generator)) if bias else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class MaskedBatchNorm(nn.Module):
    """Batch normalization over rows of ``x [N, F]``, ignoring the rows
    where ``mask`` is False.

    Train mode normalizes with the *biased* variance of the unmasked rows
    and updates the running moments with the *unbiased* one (torch
    semantics).  Eval mode normalizes with the running moments.  Same
    arithmetic as ``connectome_gnn_tpu.nn.layers.batch_norm_apply``
    (``nn/layers.py:95-142`` of the JAX package).
    """

    eps = 1e-5
    momentum = 0.1

    def __init__(self, num_features: int):
        super().__init__()
        self.num_features = int(num_features)
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward_eval_fm(self, xT: torch.Tensor) -> torch.Tensor:
        """Eval-mode normalization of FEATURE-MAJOR activations ``xT [F, N]``
        (the quantized-band serving layout): the running moments broadcast
        along the node axis, whatever the module's mode.  Same arithmetic
        as ``batch_norm_eval_fm`` (``nn/layers.py:221`` of the JAX package)."""
        y = (xT - self.running_mean[:, None]) * torch.rsqrt(self.running_var + self.eps)[:, None]
        return y * self.weight[:, None] + self.bias[:, None]

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if not self.training:
            y = (x - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
            return y * self.weight + self.bias
        m = mask.to(x.dtype)[:, None]
        n = m.sum()
        mean = (x * m).sum(dim=0) / n
        var = torch.clamp((x * x * m).sum(dim=0) / n - mean * mean, min=0.0)  # biased
        y = (x - mean) * torch.rsqrt(var + self.eps)
        with torch.no_grad():
            # Bessel's correction only in the running update (torch semantics)
            var_unbiased = var * (n / torch.clamp(n - 1.0, min=1.0))
            self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * var_unbiased)
            self.num_batches_tracked.add_(1)
        return y * self.weight + self.bias
