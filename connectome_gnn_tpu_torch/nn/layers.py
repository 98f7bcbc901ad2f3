"""Core building blocks: dense layer, masked BatchNorm and dropout.

Masked BatchNorm is why ``nn.BatchNorm1d`` cannot be used: batches are
padded to static shapes, and padded rows must stay out of the batch
moments or the statistics drift from the reference's unpadded ones.  The
module keeps ``nn.BatchNorm1d``'s parameter and buffer names (``weight``,
``bias``, ``running_mean``, ``running_var``, ``num_batches_tracked``), so a
reference checkpoint loads with ``load_state_dict``.  :class:`Dropout`
draws from a generator it is handed (the trainer's), not the global one,
so a resumed run replays it; over a mesh each shard draws from its own.
Masked BatchNorm takes an optional moment reducer, which sums its batch
moments across the shards of a mesh (sync-BatchNorm).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

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


class Dropout(nn.Module):
    """Inverted dropout, ``where(keep, x / (1 - p), 0)`` with ``keep`` drawn
    from :attr:`generator` (``dropout``, ``connectome_gnn_tpu/nn/layers.py:
    238`` of the JAX package, which takes an explicit key).

    The identity in eval mode and at ``p = 0``.  ``generator`` is ``None``
    (the global generator) until an owner such as the ``Trainer`` hands one
    over; it must live on the input's device.  The module has no parameters
    or buffers, so a model's ``state_dict`` keys are those it had with
    ``nn.Dropout``.

    ``shard_generators`` (one per local shard of a mesh, set by the mesh's
    owner) splits the input's first axis into that many equal parts, shard
    by shard, and draws each part's mask from its shard's generator: the
    masks then do not depend on how shards are spread over processes.  A
    batch merged region by region (:func:`region_major`: every shard's
    first region, then every shard's second, ...) passes its per-shard
    region lengths as ``regions``: each shard's mask is drawn in the
    shard's own layout and moved to the merged one.
    """

    def __init__(self, p: float = 0.5):
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout rate must be in [0, 1), got {p}")
        self.p = float(p)
        self.generator: Optional[torch.Generator] = None
        self.shard_generators: Optional[Sequence[torch.Generator]] = None

    def extra_repr(self) -> str:
        return f"p={self.p}"

    def forward(self, x: torch.Tensor, regions: Optional[Sequence[int]] = None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        if self.shard_generators is None:
            mask = torch.rand(x.shape, generator=self.generator, device=x.device)
        else:
            parts = len(self.shard_generators)
            if x.shape[0] % parts:
                raise ValueError(f"dropout over {parts} shards got a first axis of {x.shape[0]}")
            shape = (x.shape[0] // parts,) + tuple(x.shape[1:])
            masks = [torch.rand(shape, generator=g, device=x.device) for g in self.shard_generators]
            mask = region_major(torch.stack(masks), regions) if regions else torch.cat(masks)
        return torch.where(mask < keep, x / keep, 0.0)


def region_major(stacked: torch.Tensor, regions: Sequence[int]) -> torch.Tensor:
    """``stacked [D, N, ...]`` (``N = Σ regions``) as one ``[D·N, ...]``
    tensor region by region: every shard's first ``regions[0]`` rows, then
    every shard's next ``regions[1]`` rows, and so on."""
    return torch.cat([part.flatten(0, 1) for part in stacked.split(list(regions), dim=1)])


class MaskedBatchNorm(nn.Module):
    """Batch normalization ignoring masked-out nodes, in three layouts:
    node-major ``x [N, F]`` (:meth:`forward`), feature-major ``xT [F, N]``
    (:meth:`forward_fm`) and blocked ``xb [NB, F, block]``
    (:meth:`forward_blocked`), the layouts of the int8-band training paths.

    Train mode normalizes with the *biased* variance of the unmasked nodes
    and updates the running moments in place with the *unbiased* one (torch
    semantics).  Eval mode normalizes with the running moments.  Same
    arithmetic as ``batch_norm_apply``, ``batch_norm_apply_fm`` and
    ``batch_norm_apply_blocked`` of the JAX package
    (``connectome_gnn_tpu/nn/layers.py:95-218``).

    ``moment_reducer`` (None by default) is sync-BatchNorm: in train mode it
    maps this batch's ``(n, Σx, Σx²)`` to their sums over every shard of a
    mesh before the moments are taken, as the JAX package psums them over
    its stats axes (``nn/layers.py:121-124``).  Without one every result is
    what it was, bitwise.
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
        self.moment_reducer: Optional[Callable] = None

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Node-major ``x [N, F]``; ``mask [N]`` or None (every row real)."""
        m = None if mask is None else mask.to(x.dtype)[:, None]
        return self._normalize(x, m, dims=(0,), shape=(-1,))

    def forward_fm(self, xT: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Feature-major ``xT [F, N]``; ``mask [N]`` or None."""
        m = None if mask is None else mask.to(xT.dtype)[None, :]
        return self._normalize(xT, m, dims=(1,), shape=(-1, 1))

    def forward_blocked(self, xb: torch.Tensor, mask_b: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Blocked ``xb [NB, F, block]``; ``mask_b [NB, block]`` or None."""
        m = None if mask_b is None else mask_b.to(xb.dtype)[:, None, :]
        return self._normalize(xb, m, dims=(0, 2), shape=(1, -1, 1))

    def forward_eval_fm(self, xT: torch.Tensor) -> torch.Tensor:
        """Eval-mode normalization of feature-major ``xT [F, N]`` whatever
        the module's mode (``batch_norm_eval_fm``, ``nn/layers.py:221`` of
        the JAX package)."""
        return self._eval(xT, (-1, 1))

    def _eval(self, x: torch.Tensor, shape) -> torch.Tensor:
        y = (x - self.running_mean.view(shape)) * torch.rsqrt(self.running_var + self.eps).view(shape)
        return y * self.weight.view(shape) + self.bias.view(shape)

    def _normalize(self, x: torch.Tensor, m: Optional[torch.Tensor], dims, shape) -> torch.Tensor:
        """``m`` is the float mask broadcast against ``x``; ``dims`` the node
        axes; ``shape`` views a per-feature vector against ``x``."""
        if not self.training:
            return self._eval(x, shape)
        if m is None:
            n = x.new_tensor(float(x.numel() // self.num_features))
            sum_x, sum_x2 = x.sum(dim=dims), (x * x).sum(dim=dims)
        else:
            n = m.sum()
            sum_x, sum_x2 = (x * m).sum(dim=dims), (x * x * m).sum(dim=dims)
        if self.moment_reducer is not None:
            n, sum_x, sum_x2 = self.moment_reducer(n, sum_x, sum_x2)
        mean = sum_x / n
        var = torch.clamp(sum_x2 / n - mean * mean, min=0.0)  # biased
        y = (x - mean.view(shape)) * torch.rsqrt(var + self.eps).view(shape)
        with torch.no_grad():
            # Bessel's correction only in the running update (torch semantics)
            var_unbiased = var * (n / torch.clamp(n - 1.0, min=1.0))
            self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * var_unbiased)
            self.num_batches_tracked.add_(1)
        return y * self.weight.view(shape) + self.bias.view(shape)
