"""Weight initializers matching the reference's PyTorch init schemes.

Conv kernels use Xavier-uniform (reference ``connectome_gnn/models.py:82,
134``); head kernels and biases use PyTorch's ``nn.Linear`` default, whose
Kaiming-uniform kernel with ``a=√5`` is ``U(±1/√fan_in)``, as is its bias.

Kernels are returned in torch's ``[out, in]`` layout.  Every draw comes from
an explicit ``torch.Generator``, so a model built from one seed is
reproducible without touching the global RNG.  The numbers differ from the
JAX package's ``jax.random`` draws for the same seed; parity tests carry
the JAX weights across with :func:`~connectome_gnn_tpu_torch.models.compat.
load_jax_params` instead.
"""

from __future__ import annotations

import math

import torch


def _uniform(shape, bound: float, generator: torch.Generator) -> torch.Tensor:
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


def xavier_uniform(
    in_features: int, out_features: int, generator: torch.Generator
) -> torch.Tensor:
    """Glorot/Xavier uniform kernel ``[out, in]``: U(±√(6/(fan_in+fan_out)))."""
    bound = math.sqrt(6.0 / (in_features + out_features))
    return _uniform((out_features, in_features), bound, generator)


def torch_linear_kernel(
    in_features: int, out_features: int, generator: torch.Generator
) -> torch.Tensor:
    """PyTorch ``nn.Linear`` default kernel ``[out, in]``: U(±1/√fan_in)."""
    return _uniform((out_features, in_features), 1.0 / math.sqrt(in_features), generator)


def torch_linear_bias(
    in_features: int, out_features: int, generator: torch.Generator
) -> torch.Tensor:
    """PyTorch ``nn.Linear`` default bias ``[out]``: U(±1/√fan_in)."""
    return _uniform((out_features,), 1.0 / math.sqrt(in_features), generator)
