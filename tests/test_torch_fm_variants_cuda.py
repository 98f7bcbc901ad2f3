"""The feature-major band-pipeline kernels B3a-B3d (``ops/fm_variants.py``;
all on ``csrc/band_mma.cu``: K5's launch for ``fm_w8a8``, role B for
``fm_bf16_band``, ``fm_compute_only`` (with its panel map), ``fm_deep`` and
``fm_blocked``, and role B's TMA ring with a copy-plus-add consumer,
``Variant::kDmaOnly``, for ``fm_dma_only``) against their plain PyTorch
versions, on the card.

Every test here needs a CUDA card and skips without one.  The machine with
the card has no JAX, and ``tests/conftest.py`` imports it, so run them
there without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fm_variants_cuda.py

This file imports no JAX.  Tolerance: kernel against plain version rtol
1e-5 / atol 1e-5 (the same exact products, float32 sums in another order);
``fm_dma_only`` bitwise (one float32 add), also at blocks of 40 (padded to
48), 16 and 48; ``fm_w8a8`` bitwise against its
plain version and against K5's kernel on K5's operands (it is K5's launch:
exact int32 dots, then the scale's product and the sum rounded apart, as
the plain version rounds), at every shape and at blocks of 40 (padded to
48), 16 and 48; ``fm_deep``, which
is K4's launch, bitwise against role B's launch on the bfloat16 frame
``pad_xT`` builds (the same products in the same order: K4 rounds x to
bfloat16 in registers as ``pad_xT`` does).
``fm_deep``'s and ``fm_blocked``'s ``rows_per_step``, ``depth`` and
``band_splits`` shape nothing on this card: each of the script's values
gives the one result.  The bands are random and NON-symmetric, so a
swapped tile axis cannot go unseen.
"""

import numpy as np
import pytest
import torch

from connectome_gnn_tpu_torch.ops import band_mma
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
    if kid == "w8a8":
        assert torch.equal(got, want)
        return
    tol = 0 if kid == "dma_only" else RTOL
    torch.testing.assert_close(got, want, rtol=tol, atol=0 if kid == "dma_only" else ATOL)


@pytest.mark.parametrize("K", fv.BAND_SPLITS)
@pytest.mark.parametrize("S", fv.DEPTHS)
def test_fm_deep_at_every_depth_and_split(cuda, S, K):
    """Each (S, K) gives the one result: the plain version's, and the
    kernel's at the default (R, S, K) bit for bit."""
    ops = Operands(16, 2, 64, 1000, 16, seed=S * 10 + K, device=cuda)
    got = fv.fm_deep_kernel(ops.q, ops.xT, rows_per_step=4, depth=S, band_splits=K)
    torch.testing.assert_close(got, fv.fm_deep_reference(ops.q, ops.xT), rtol=RTOL, atol=ATOL)
    assert torch.equal(got, fv.fm_deep_kernel(ops.q, ops.xT))


@pytest.mark.parametrize("S", fv.DEPTHS)
def test_fm_blocked_at_every_depth(cuda, S):
    """Each S gives the one result, as for ``fm_deep``."""
    ops = Operands(16, 1, 64, 1024, 24, seed=S, device=cuda)
    got = fv.fm_blocked_kernel(ops.q, ops.xb, rows_per_step=8, depth=S)
    torch.testing.assert_close(got, fv.fm_blocked_reference(ops.q, ops.xb), rtol=RTOL, atol=ATOL)
    assert torch.equal(got, fv.fm_blocked_kernel(ops.q, ops.xb))


@pytest.mark.parametrize("kid", ["deep", "blocked"])
def test_role_b_pads_a_block_that_is_not_a_multiple_of_16(cuda, kid):
    """``fm_deep`` and ``fm_blocked`` take any block: their wrappers pad
    the band and the frame to a multiple of 16 with zeros."""
    ops = Operands(6, 1, 40, 230, 5, seed=11, device=cuda)
    got = run(kid, "kernel", ops, 2)
    torch.testing.assert_close(got, run(kid, "plain", ops, 2), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", [(12, 2, 256, 3000, 64), (10, 1, 48, 470, 16), (9, 0, 16, 140, 70)])
def test_bf16_frame_launch_is_fm_deeps_bit_for_bit(cuda, shape):
    """On the same band: ``fm_deep`` (K4's launch on the float32 ``xT``,
    which the kernel rounds in registers) and role B's launch on the
    bfloat16 frame ``fm_frame(pad_xT(xT))`` give the same output."""
    nb, W, block, n, F = shape
    ops = Operands(nb, W, block, n, F, seed=sum(shape), device=cuda)
    x_pad = band_mma.fm_frame(fv.pad_xT(ops.xT, n, nb, W, block), nb, W, block)
    bf16 = band_mma.launch_fm("B3c", band_mma.pad_band(ops.q.band_qT), ops.q.scales, x_pad, W, block)
    assert torch.equal(bf16[:, :n], fv.fm_deep_kernel(ops.q, ops.xT))


@pytest.mark.parametrize("shape", [(20, 2, 256, 5000, 64), (7, 1, 48, 330, 16)])
def test_fm_deep_and_fm_blocked_over_six_decades(cuda, shape):
    """Scales and activations spread over three decades each way: each
    output within 1e-5 of the sum of its products' magnitudes."""
    nb, W, block, n, F = shape
    ops = Operands(nb, W, block, n, F, seed=sum(shape), device=cuda)
    rng = np.random.default_rng(n)
    q = ops.q._replace(scales=torch.from_numpy(
        (10.0 ** rng.uniform(-3, 3, ops.q.scales.shape)).astype(np.float32)).to(cuda))
    xT = ops.xT * torch.from_numpy((10.0 ** rng.uniform(-3, 3, (F, n))).astype(np.float32)).to(cuda)
    xb = bq.to_blocked(fv.pad_xT(xT, n, nb, W, block), block)
    q_abs = q._replace(band_qT=q.band_qT.abs())
    for got, want, magnitude in (
            (fv.fm_deep_kernel(q, xT), fv.fm_deep_reference(q, xT), fv.fm_deep_reference(q_abs, xT.abs())),
            (fv.fm_blocked_kernel(q, xb), fv.fm_blocked_reference(q, xb),
             fv.fm_blocked_reference(q_abs, xb.abs()))):
        assert bool(((got - want).abs() <= 1e-5 * magnitude).all())


def test_fm_blocked_launch_alone_equals_the_wrapper(cuda):
    """At the main shape's layout (b = 256, F = 64) B3d's wrapper hands the
    kernel the band and the caller's ``xb`` as they are."""
    ops = Operands(12, 2, 256, 3000, 64, seed=8, device=cuda)
    assert band_mma.blocked_x_operand(ops.xb, 256) is ops.xb
    alone = band_mma.launch_blocked("B3d", ops.q.band_qT, ops.q.scales, ops.xb, 2, 256)
    assert torch.equal(alone, fv.fm_blocked(ops.q, ops.xb))


def test_fm_w8a8_is_k5_on_its_operands(cuda):
    """K5 quantizes the float32-padded frame; fm_w8a8 on those operands is
    K5's function, and both kernels take exact int32 dots."""
    ops = Operands(8, 2, 256, 2000, 64, seed=5, device=cuda)
    xq, xs = bq.quantize_activations_padded(ops.q, ops.xT)
    got = fv.fm_w8a8_kernel(ops.q, xq, xs, rows_per_step=4)
    assert torch.equal(got, bq.banded_spmm_quant_fm_w8a8_kernel(ops.q, ops.xT))


@pytest.mark.parametrize("shape", [(6, 1, 40, 230, 5, 3), (12, 1, 16, 180, 8, 4), (10, 2, 48, 470, 130, 5)])
def test_fm_w8a8_takes_any_block(cuda, shape):
    """A block of 40, which the CUDA-core body it replaced refused and K5's
    launch takes padded to 48, and of 16 and 48 (one partial 128-sender
    chunk): bit for bit the plain version, and K5's kernel on K5's
    operands."""
    nb, W, block, n, F, R = shape
    ops = Operands(nb, W, block, n, F, seed=sum(shape), device=cuda)
    got = fv.fm_w8a8_kernel(ops.q, ops.xq, ops.xscales, rows_per_step=R)
    assert got.shape == (F, n)
    assert torch.equal(got, fv.fm_w8a8_reference(ops.q, ops.xq, ops.xscales, rows_per_step=R))
    xq, xs = bq.quantize_activations_padded(ops.q, ops.xT)
    assert torch.equal(fv.fm_w8a8_kernel(ops.q, xq, xs, rows_per_step=R),
                       bq.banded_spmm_quant_fm_w8a8_kernel(ops.q, ops.xT))


@pytest.mark.parametrize("shape", [(6, 1, 40, 230, 5, 3), (12, 1, 16, 180, 16, 4), (10, 2, 48, 470, 48, 5),
                                   (4, 0, 160, 610, 130, 2)])
def test_fm_dma_only_takes_any_block(cuda, shape):
    """A block of 40, which the CUDA-core body it replaced refused and role
    B's ring takes padded to 48; of 16 and 48 (one partial 64-sender stage
    carries every receiver and feature, F = b); and F = 130 at a block of
    160 (band rows from sender chunks 0-2): bit for bit the plain version,
    and the launch alone on the wrapper's frame the wrapper's output."""
    nb, W, block, n, F, R = shape
    ops = Operands(nb, W, block, n, F, seed=sum(shape), device=cuda)
    got = fv.fm_dma_only_kernel(ops.q, ops.xT, rows_per_step=R)
    assert got.shape == (F, n)
    assert torch.equal(got, fv.fm_dma_only_reference(ops.q, ops.xT, rows_per_step=R))
    x_pad = fv.pad_xT(ops.xT, n, nb, W, block)
    assert torch.equal(fv._launch_dma_only(ops.q, x_pad), got)


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
    wide = Operands(4, 1, 40, 160, 48, seed=4, device=cuda)
    before = fv.fm_dma_only_kernel.launches
    with pytest.raises(ValueError, match="exceeds the block"):
        fv.fm_dma_only_kernel(wide.q, wide.xT, rows_per_step=2)
    assert fv.fm_dma_only_kernel.launches == before
    with pytest.raises(ValueError, match="share"):
        fv.fm_deep_kernel(ops.q._replace(band_qT=ops.q.band_qT.cpu()), ops.xT)
    with pytest.raises(ValueError, match="depth"):
        fv.fm_blocked_kernel(ops.q, ops.xb, depth=5)
    with pytest.raises(ValueError, match="contiguous"):
        fv.fm_blocked_kernel(ops.q, ops.xb.float())
    with pytest.raises(ValueError, match="contiguous"):
        fv.fm_w8a8_kernel(ops.q, ops.xq.float(), ops.xscales, rows_per_step=4)
