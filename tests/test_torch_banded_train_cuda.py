"""K6 and the trainable band ops against their plain PyTorch versions, on
the card.

Every test here needs a CUDA card and skips without one.  The machine with
the card has no JAX, and ``tests/conftest.py`` imports it, so run them
there without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_banded_train_cuda.py

This file imports no JAX.  Tolerances: kernel against plain version rtol
1e-5 / atol 1e-5 (the same exact products, float32 sums in another order).
A 4000-node train step against its plain path: loss rtol 1e-5, each
gradient and running moment within 5e-3 of its norm in relative Frobenius
error (plus 1e-6 for the conv biases, whose gradients BatchNorm cancels to
noise).  The sum-order difference, re-rounded to bf16 at the next band
pass, moves the second BatchNorm's output by up to 2.8e-3, and a ReLU input
that close to zero changes side, its cotangent jumping: measured on an
H100, one such input in the blocked step moved single gradient entries by
up to 2.5e-5, 6e-4 of their tensor's norm, since at 4000 nodes one node
weighs 1/4000 of the loss.  At the million-node shape of
``chip_smoke.py`` the same comparison holds elementwise at rtol 1e-4 /
atol 1e-5.
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import connectome_gnn_tpu_torch as tp
from connectome_gnn_tpu_torch.ops import banded as tb
from connectome_gnn_tpu_torch.ops import banded_quant as bq

pytestmark = pytest.mark.requires_cuda

RTOL, ATOL = 1e-5, 1e-5
STEP_LOSS_RTOL, STEP_REL_FRO, STEP_FRO_ATOL = 1e-5, 5e-3, 1e-6
#: (num_blocks, W, block, num_nodes, F): the ragged tail, W = 0, F = 5, a
#: block of 100 with two feature slices, the full block
SHAPES = [(10, 1, 64, 640, 16), (10, 1, 64, 600, 16), (10, 0, 64, 600, 16),
          (10, 2, 64, 640, 5), (7, 1, 100, 650, 70), (16, 2, 256, 4000, 64)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def random_operands(nb, W, block, n, seed, device):
    """A random NON-symmetric int8 band (70 % zeros, tail tiles non-zero)
    as the forward operand and its transpose, feature-major."""
    rng = np.random.default_rng(seed)
    shape = (nb, 2 * W + 1, block, block)
    q = (rng.integers(-127, 128, shape) * (rng.random(shape) < 0.3)).astype(np.int8)
    scales = rng.uniform(1e-3, 1.1e-2, shape[:2]).astype(np.float32)
    q_row = bq.QuantizedBandedMatrix(torch.from_numpy(q).to(device),
                                     torch.from_numpy(scales).to(device), n, W)
    return bq.to_feature_major(q_row), bq.transposed_feature_major(q_row)


def randn(shape, seed, device):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32)).to(device)


@pytest.mark.parametrize("shape", SHAPES)
def test_k6_matches_its_plain_version(cuda, shape):
    nb, W, block, n, F_ = shape
    q, _ = random_operands(nb, W, block, n, seed=sum(shape), device=cuda)
    xb_pad = randn((nb + 2 * W, F_, block), n, cuda)  # the whole frame, tail and halo included
    before = bq.banded_spmm_quant_blocked_kernel.launches
    got = bq.banded_spmm_quant_blocked(q, xb_pad)
    torch.cuda.synchronize()
    assert bq.banded_spmm_quant_blocked_kernel.launches == before + 1
    torch.testing.assert_close(got, bq.banded_spmm_quant_blocked_reference(q, xb_pad),
                               rtol=RTOL, atol=ATOL)


def test_k6_refuses_operands_it_does_not_take(cuda):
    q, _ = random_operands(10, 1, 64, 600, seed=1, device=cuda)
    with pytest.raises(ValueError, match="contiguous float32"):
        bq.banded_spmm_quant_blocked_kernel(q, torch.zeros((12, 16, 64), dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError, match="contiguous float32"):
        bq.banded_spmm_quant_blocked_kernel(q, torch.zeros((12, 64, 16), device=cuda).transpose(1, 2))
    with pytest.raises(ValueError, match="activations must be"):
        bq.banded_spmm_quant_blocked_kernel(q, torch.zeros((10, 16, 64), device=cuda))


@pytest.mark.parametrize("shape", SHAPES[:4] + SHAPES[-1:])
def test_trainable_ops_match_the_plain_path(cuda, shape):
    """Forward and activation gradient, kernels against ``plain=True``; K4
    runs once forward and once (over qT) backward, K6 twice."""
    nb, W, block, n, F_ = shape
    q, qT = random_operands(nb, W, block, n, seed=sum(shape) + 1, device=cuda)
    for op, x_shape, kernel, fwd_kernel in (
        (bq.banded_spmm_quant_fm_grad, (F_, n), bq.banded_spmm_quant_fm_grad_kernel,
         bq.banded_spmm_quant_fm_kernel),
        (bq.banded_spmm_quant_blocked_grad, (nb, F_, block), bq.banded_spmm_quant_blocked_kernel,
         bq.banded_spmm_quant_blocked_kernel),
    ):
        x, cot = randn(x_shape, 2, cuda), randn(x_shape, 3, cuda)
        grads = []
        for plain in (False, True):
            v = x.clone().requires_grad_()
            before = (kernel.launches, fwd_kernel.launches)
            out = op(q, qT, v, plain=plain)
            (out * cot).sum().backward()
            torch.cuda.synchronize()
            launched = (kernel.launches - before[0], fwd_kernel.launches - before[1])
            assert launched == ((0, 0) if plain else (1, 2) if kernel is not fwd_kernel else (2, 2))
            grads.append((out.detach(), v.grad))
        for got, want in zip(*grads):
            torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_blocked_and_feature_major_gradients_agree(cuda):
    q, qT = random_operands(16, 2, 256, 4096, seed=7, device=cuda)
    xb, cot = randn((16, 64, 256), 4, cuda).requires_grad_(), randn((16, 64, 256), 5, cuda)
    (bq.banded_spmm_quant_blocked_grad(q, qT, xb) * cot).sum().backward()
    xT = bq.from_blocked(xb.detach()).contiguous().requires_grad_()
    (bq.banded_spmm_quant_fm_grad(q, qT, xT) * bq.from_blocked(cot)).sum().backward()
    torch.testing.assert_close(bq.from_blocked(xb.grad), xT.grad, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("method", ["apply_quant_trainable", "apply_quant_trainable_blocked"])
def test_train_step_launch_counts_and_plain_path(cuda, method):
    g = tp.generate_spatial_graph(4000, degree=12, band=256, num_features=16, seed=3)
    a = tb.to_banded(g.edge_index[0], g.edge_index[1], g.edge_weight, 4000, block=256, device=cuda)
    x = torch.from_numpy(g.node_features).to(cuda)
    labels = torch.from_numpy(np.random.default_rng(0).integers(0, 2, 4000)).to(cuda)
    model = tp.BandedNodeGCN(in_channels=16, hidden_dim=64, num_layers=2,
                             generator=torch.Generator().manual_seed(0)).to(cuda).train()
    prep = model.prepare_quant_trainable(a)
    kernels = (bq.banded_spmm_quant_fm_kernel, bq.banded_spmm_quant_fm_grad_kernel,
               bq.banded_spmm_quant_blocked_kernel)
    results = []
    for plain in (False, True):
        m = copy.deepcopy(model)
        before = [k.launches for k in kernels]
        loss = F.cross_entropy(getattr(m, method)(*prep, x, plain=plain), labels)
        loss.backward()
        torch.cuda.synchronize()
        launched = [k.launches - b for k, b in zip(kernels, before)]
        if plain:
            assert launched == [0, 0, 0]
        else:
            assert launched == ([4, 2, 0] if method == "apply_quant_trainable" else [0, 0, 4])
        results.append((loss.detach(), [p.grad for p in m.parameters()], list(m.buffers())))
    (loss, grads, bufs), (loss_p, grads_p, bufs_p) = results
    torch.testing.assert_close(loss, loss_p, rtol=STEP_LOSS_RTOL, atol=0.0)
    for a_, b_ in zip(grads + bufs, grads_p + bufs_p):
        err = float(torch.linalg.norm((a_ - b_).double()))
        assert err <= STEP_REL_FRO * float(torch.linalg.norm(b_.double())) + STEP_FRO_ATOL, err
