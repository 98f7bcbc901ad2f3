"""Mixed precision on the card: ``mixed_matmul`` on the card against the
same emulation on the CPU, and a bfloat16 model's ``predict`` through K1
and K2.

Every test here needs a CUDA card and skips without one.  The machine with
the card has no JAX, and ``tests/conftest.py`` imports it, so run them
there without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_mixed_precision_cuda.py

This file imports no JAX.  The gate is ``test_torch_mixed_precision.py``'s:
within 1e-5 · Σ|a|·|b| of the float64 product of the bfloat16-rounded
operands, which a bfloat16 output fails; the gradients within one
bfloat16 step of the CPU's.  Both must hold with TF32 and bfloat16
reduced-precision reduction switched on by the caller (the product pins
both off, forward and backward, and restores them).
"""

import numpy as np
import pytest
import torch

import connectome_gnn_tpu_torch as tp
from connectome_gnn_tpu_torch.models import layers as tl
from connectome_gnn_tpu_torch.ops import fused as tf

pytestmark = pytest.mark.requires_cuda

SHAPES = [((1344, 64), (64, 64)), ((16, 88, 88), (16, 88, 64)), ((16, 88, 5), (5, 64)),
          ((16, 88, 128), (128, 64))]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def product_gate(a, b, got):
    """The worst ratio of |got - float64 product of the rounded operands|
    to 1e-5 · Σ|a|·|b|."""
    a64, b64 = tl.round_bf16(a).double(), tl.round_bf16(b).double()
    want = torch.matmul(a64, b64)
    return float(((got.double() - want).abs() / (1e-5 * torch.matmul(a64.abs(), b64.abs()))).max())


@pytest.mark.parametrize("flags_on", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_card_route_meets_the_gate_under_either_flag_setting(cuda, shape, flags_on):
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda) for s in shape)
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction
    try:
        matmul.allow_tf32 = matmul.allow_bf16_reduced_precision_reduction = flags_on
        got = tl.mixed_matmul(a, b, torch.bfloat16)
        assert (matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction) == (flags_on, flags_on)
    finally:
        matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction = saved
    assert got.dtype == torch.float32 and got.is_cuda
    assert product_gate(a.cpu(), b.cpu(), got.cpu()) <= 1.0
    emulated = tl.mixed_matmul(a.cpu(), b.cpu(), torch.bfloat16)
    assert product_gate(a.cpu(), b.cpu(), emulated) <= 1.0
    bf16_output = torch.matmul(a.bfloat16(), b.bfloat16()).float().cpu()
    assert product_gate(a.cpu(), b.cpu(), bf16_output) > 1.0


@pytest.mark.parametrize("flags_on", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_card_gradients_are_the_emulations(cuda, shape, flags_on):
    """The card's backward against the CPU's autograd of the emulation:
    each rounded to bfloat16 last, so at most one bfloat16 step (2^-7
    relative) apart, plus 1e-5 of the products' magnitudes for the order
    of the float32 sums."""
    rng = np.random.default_rng(1)
    a, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shape)
    grad = torch.from_numpy(rng.standard_normal(tl.mixed_matmul(a, b).shape).astype(np.float32))
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction
    ac, bc = (t.to(cuda).requires_grad_() for t in (a, b))
    try:
        matmul.allow_tf32 = matmul.allow_bf16_reduced_precision_reduction = flags_on
        tl.mixed_matmul(ac, bc, torch.bfloat16).backward(grad.to(cuda))
        torch.cuda.synchronize()
    finally:
        matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction = saved
    a0, b0 = (t.detach().clone().requires_grad_() for t in (a, b))
    tl.mixed_matmul(a0, b0, torch.bfloat16).backward(grad)
    a16, b16 = tl.round_bf16(a).abs(), tl.round_bf16(b).abs()
    scale_a = grad.abs() @ b16.transpose(-1, -2)
    if b.dim() == 2:
        scale_b = a16.reshape(-1, a.shape[-1]).t() @ grad.abs().reshape(-1, grad.shape[-1])
    else:
        scale_b = a16.transpose(-1, -2) @ grad.abs()
    for got, want, scale in ((ac.grad.cpu(), a0.grad, scale_a), (bc.grad.cpu(), b0.grad, scale_b)):
        assert bool(((got - want).abs() <= 2.0 ** -7 * want.abs() + 1e-5 * scale).all())


@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_bf16_predict_launches_the_fused_kernel(cuda, kind):
    cls = tp.GCNConnectome if kind == "gcn" else tp.GraphSAGEConnectome
    kernel = tf.fused_gcn_kernel if kind == "gcn" else tf.fused_sage_kernel
    graphs = tp.generate_dataset(num_subjects=40, seed=1)
    loader = tp.ConnectomeDataLoader(graphs, batch_size=16, shuffle=False, layout="dense", device=cuda)
    model = cls(in_channels=5, hidden_dim=64, compute_dtype=torch.bfloat16,
                generator=torch.Generator().manual_seed(0))
    f32 = cls(in_channels=5, hidden_dim=64, generator=torch.Generator().manual_seed(0))
    before = kernel.launches
    got = tp.Trainer(model, device=cuda).predict(loader)
    assert kernel.launches - before == len(loader) == 3
    want = tp.Trainer(f32, device=cuda).predict(loader, prefer_fused=False)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
