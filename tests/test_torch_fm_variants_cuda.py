"""The feature-major band-pipeline kernels B3a-B3d (``ops/fm_variants.py``,
``csrc/fm_pipeline.cu``) against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one.  The machine with
the card has no JAX, and ``tests/conftest.py`` imports it, so run them
there without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fm_variants_cuda.py

This file imports no JAX.  Tolerance: kernel against plain version rtol
1e-5 / atol 1e-5 (the same exact products, float32 sums in another order);
``fm_dma_only`` bitwise (one float32 add); ``fm_w8a8`` bitwise against K5's
kernel on K5's operands (both take exact int32 dots).  The bands are random
and NON-symmetric, so a swapped tile axis cannot go unseen.
"""

import numpy as np
import pytest
import torch

from connectome_gnn_tpu_torch.ops import banded_quant as bq
from connectome_gnn_tpu_torch.ops import fm_variants as fv

pytestmark = pytest.mark.requires_cuda

RTOL, ATOL = 1e-5, 1e-5
#: (num_blocks, W, block, num_nodes, F, R): W = 0, 1, 2; F = 1, 5, 16, 64
#: and 100 (two feature slices); ragged tails; blocks of 48 (a half-empty
#: stage of senders), 80 (a half-empty receiver tile) and 256
SHAPES = [(8, 1, 64, 512, 16, 4), (12, 0, 64, 768, 16, 2), (12, 2, 64, 700, 5, 4),
          (8, 1, 64, 500, 1, 2), (8, 2, 64, 512, 64, 4), (10, 1, 48, 470, 16, 5),
          (5, 1, 80, 400, 20, 5), (4, 1, 64, 256, 100, 2), (6, 2, 256, 1500, 64, 2)]
KERNELS = ["dma_only", "compute_only", "bf16_band", "w8a8", "deep", "blocked"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


class Operands:
    """A random non-symmetric int8 band (70 % zeros; tile (0, 0) all zero,
    scale 1) in the feature-major form, its bfloat16 copy with the same
    scales, activations and their padded forms, on ``device``."""

    def __init__(self, nb, W, block, n, F, seed, device):
        rng = np.random.default_rng(seed)
        shape = (nb, 2 * W + 1, block, block)
        band_q = (rng.integers(-127, 128, shape) * (rng.random(shape) < 0.3)).astype(np.int8)
        scales = rng.uniform(1e-3, 1.1e-2, shape[:2]).astype(np.float32)
        band_q[0, 0], scales[0, 0] = 0, 1.0
        q = bq.QuantizedBandedMatrix(torch.from_numpy(band_q).to(device),
                                     torch.from_numpy(scales).to(device), n, W)
        self.q = bq.to_feature_major(q)
        self.band_bf16T = (self.q.band_qT.float() * rng.uniform(0.5, 2.0)).to(torch.bfloat16)
        self.xT = torch.from_numpy(rng.standard_normal((F, n)).astype(np.float32)).to(device)
        x_pad = fv.pad_xT(self.xT, n, nb, W, block)
        self.xq, self.xscales = fv.quantize_xT_blocks(x_pad, block)
        self.xb = bq.to_blocked(x_pad, block)
        self.n, self.W = n, W


def run(kid, which, ops, R, **kw):
    """Kernel ``kid`` (``which`` = "kernel", "entry" or "plain") on ``ops``."""
    name = {"kernel": f"fm_{kid}_kernel", "entry": f"fm_{kid}", "plain": f"fm_{kid}_reference"}[which]
    fn, q = getattr(fv, name), ops.q
    if kid == "bf16_band":
        return fn(ops.band_bf16T, q.scales, ops.n, ops.W, ops.xT, R)
    if kid == "w8a8":
        return fn(q, ops.xq, ops.xscales, R)
    if kid == "blocked":
        return fn(q, ops.xb, R, **kw)
    return fn(q, ops.xT, R, **kw)


@pytest.mark.parametrize("kid", KERNELS)
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain_version(cuda, kid, shape):
    nb, W, block, n, F, R = shape
    if kid == "dma_only" and F > block:
        pytest.skip("fm_dma_only takes F <= block")
    ops = Operands(nb, W, block, n, F, seed=sum(shape), device=cuda)
    kernel = getattr(fv, f"fm_{kid}_kernel")
    before = kernel.launches
    got = run(kid, "kernel", ops, R)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = run(kid, "plain", ops, R)
    assert got.shape == want.shape and got.dtype == torch.float32
    tol = 0 if kid == "dma_only" else RTOL
    torch.testing.assert_close(got, want, rtol=tol, atol=0 if kid == "dma_only" else ATOL)


@pytest.mark.parametrize("K", fv.BAND_SPLITS)
@pytest.mark.parametrize("S", fv.DEPTHS)
def test_fm_deep_at_every_depth_and_split(cuda, S, K):
    ops = Operands(16, 2, 64, 1000, 16, seed=S * 10 + K, device=cuda)
    got = fv.fm_deep_kernel(ops.q, ops.xT, rows_per_step=4, depth=S, band_splits=K)
    torch.testing.assert_close(got, fv.fm_deep_reference(ops.q, ops.xT), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("S", fv.DEPTHS)
def test_fm_blocked_at_every_depth(cuda, S):
    ops = Operands(16, 1, 64, 1024, 24, seed=S, device=cuda)
    got = fv.fm_blocked_kernel(ops.q, ops.xb, rows_per_step=8, depth=S)
    torch.testing.assert_close(got, fv.fm_blocked_reference(ops.q, ops.xb), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("S", fv.DEPTHS)
def test_dma_only_probe_at_every_depth(cuda, S):
    """The copy-plus-add body through a deeper ring (the TPU kernel's is
    2-deep) gives the same output, bit for bit, and counts as a launch."""
    ops = Operands(16, 2, 64, 1000, 16, seed=S, device=cuda)
    before = fv.fm_dma_only_kernel.launches
    x_pad = fv.pad_xT(ops.xT, ops.n, 16, 2, 64)
    got = fv._launch_dma_only(ops.q, x_pad, 4, S)[:, : ops.n]
    assert fv.fm_dma_only_kernel.launches == before + 1
    assert torch.equal(got, fv.fm_dma_only_reference(ops.q, ops.xT, 4))


def test_fm_w8a8_is_k5_on_its_operands(cuda):
    """K5 quantizes the float32-padded frame; fm_w8a8 on those operands is
    K5's function, and both kernels take exact int32 dots."""
    ops = Operands(8, 2, 256, 2000, 64, seed=5, device=cuda)
    xq, xs = bq.quantize_activations_padded(ops.q, ops.xT)
    got = fv.fm_w8a8_kernel(ops.q, xq, xs, rows_per_step=4)
    assert torch.equal(got, bq.banded_spmm_quant_fm_w8a8_kernel(ops.q, ops.xT))


def test_fm_compute_only_reads_only_panel_0(cuda):
    ops = Operands(12, 1, 64, 768, 16, seed=7, device=cuda)
    got = fv.fm_compute_only_kernel(ops.q, ops.xT, rows_per_step=2)
    band = ops.q.band_qT.clone()
    band[2:] = 0
    again = fv.fm_compute_only_kernel(ops.q._replace(band_qT=band), ops.xT, rows_per_step=2)
    assert torch.equal(got, again)


@pytest.mark.parametrize("kid", KERNELS)
def test_entry_points_launch_the_kernel_on_cuda_tensors(cuda, kid):
    ops = Operands(8, 1, 64, 512, 16, seed=3, device=cuda)
    kernel = getattr(fv, f"fm_{kid}_kernel")
    before = kernel.launches
    run(kid, "entry", ops, 4)
    assert kernel.launches == before + 1


def test_kernels_refuse_operands_they_do_not_take(cuda):
    ops = Operands(8, 1, 64, 512, 16, seed=4, device=cuda)
    odd = Operands(4, 1, 40, 160, 8, seed=4, device=cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        fv.fm_deep_kernel(odd.q, odd.xT, rows_per_step=2)
    with pytest.raises(ValueError, match="share"):
        fv.fm_deep_kernel(ops.q._replace(band_qT=ops.q.band_qT.cpu()), ops.xT)
    with pytest.raises(ValueError, match="depth"):
        fv.fm_blocked_kernel(ops.q, ops.xb, depth=5)
    with pytest.raises(ValueError, match="contiguous"):
        fv.fm_blocked_kernel(ops.q, ops.xb.float())
    with pytest.raises(ValueError, match="contiguous"):
        fv.fm_w8a8_kernel(ops.q, ops.xq.float(), ops.xscales, rows_per_step=4)
