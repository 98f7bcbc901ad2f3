"""The tensor-core band body (``csrc/band_mma.cu``: K7 over a bfloat16 or
float32 band, B2a and B2c in role A, ``fm_bf16_band`` in role B) against
the plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one.  The machine with
the card has no JAX, and ``tests/conftest.py`` imports it, so run them
there without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_band_mma_cuda.py

This file imports no JAX.  The shapes are those the wrappers pad (blocks
of 100 and 40, F = 1, 5 and 70), those with more work units than the card
has SMs in a number that does not divide (the kernel's thread blocks are
persistent), and a 256-node block at F = 64 (the main shape's tiles).
Tolerance: rtol 1e-5 / atol 1e-5 against the plain version (the same exact
products, float32 sums in another order).  A band whose entries span six
decades shows whether the tensor cores' float32 accumulation differs from
IEEE float32 sums in another order: each output is held to 1e-5 of the sum
of its products' magnitudes, ``|A| @ |x̂|``.  K7 over a float32 band and
B2c without ``wrow_bf16`` are held at 1e-5 to their plain versions summed
in float64, and to the float32 plain versions within 1e-5 of that
magnitude sum (``tests/test_torch_band_variants_cuda.py`` says why).
"""

import numpy as np
import pytest
import torch

from connectome_gnn_tpu_torch.ops import band_mma
from connectome_gnn_tpu_torch.ops import band_variants as tv
from connectome_gnn_tpu_torch.ops import banded_direct as tdir
from connectome_gnn_tpu_torch.ops import banded_quant as bq
from connectome_gnn_tpu_torch.ops import fm_variants as fv
from connectome_gnn_tpu_torch.ops.banded import BandedMatrix

pytestmark = pytest.mark.requires_cuda

RTOL, ATOL = 1e-5, 1e-5
#: |kernel - plain| against |A| @ |x̂| on the wide-range band
MAGNITUDE_RTOL = 1e-5
#: (num_blocks, W, block, num_nodes, F): padded blocks and features, W = 0,
#: ragged tails; 137 and 263 row blocks (more units than SMs, not a
#: multiple); the main shape's 256-node block
SHAPES = [(7, 1, 100, 650, 70), (9, 0, 40, 350, 5), (6, 2, 100, 600, 1), (137, 1, 64, 8700, 16),
          (263, 2, 48, 12600, 24), (20, 2, 256, 5000, 64), (12, 1, 256, 3072, 130)]
ROWMAJOR = {"K7-bf16": (tdir.banded_spmm_direct_kernel, tdir.banded_spmm_direct_reference),
            "B2a": (tv.banded_spmm_bf16_kernel, tv.banded_spmm_bf16_reference)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def operands(shape, device, decades=0.0, dtype=torch.bfloat16):
    """A random non-symmetric band of ``dtype`` (70 % zeros, tile (0, 0) all
    zero), per-tile scales and activations; with ``decades`` the band's and
    x's magnitudes spread log-uniformly over that many decades each way."""
    nb, W, block, n, F = shape
    rng = np.random.default_rng(sum(shape))
    dims = (nb, 2 * W + 1, block, block)
    band = rng.standard_normal(dims) * (rng.random(dims) < 0.3)
    x = rng.standard_normal((n, F))
    if decades:
        band *= 10.0 ** rng.uniform(-decades, decades, dims)
        x *= 10.0 ** rng.uniform(-decades, decades, (n, F))
    band[0, 0] = 0
    scales = rng.uniform(1e-3, 1.1e-2, dims[:2])
    as_t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)  # noqa: E731
    return as_t(band).to(dtype), as_t(scales), as_t(x)


def rowmajor(kid, fn, band, x, shape):
    nb, W, block, n, F = shape
    if kid == "B2a":
        return fn(band, n, W, x)
    return fn(BandedMatrix(band, n, W), x)


@pytest.mark.parametrize("kid", list(ROWMAJOR))
@pytest.mark.parametrize("shape", SHAPES)
def test_rowmajor_kernel_matches_plain_version(cuda, kid, shape):
    kernel, plain = ROWMAJOR[kid]
    band, _, x = operands(shape, cuda)
    before = kernel.launches
    got = rowmajor(kid, kernel, band, x, shape)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert got.shape == (shape[3], shape[4]) and got.dtype == torch.float32
    torch.testing.assert_close(got, rowmajor(kid, plain, band, x, shape), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kid", ["K7-f32", "B2c", "B2c-wrow-bf16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_rowmajor_float32_and_int8_bands_match_plain_versions(cuda, kid, shape):
    """The float32 band's 32-sender stages and three frames, and B2c over
    K3's operands, at the padded and persistent shapes."""
    nb, W, block, n, F = shape
    band, _, x = operands(shape, cuda, dtype=torch.float32)
    a = BandedMatrix(band, n, W)
    if kid == "K7-f32":
        kernel, run = tdir.banded_spmm_direct_kernel, lambda fn, **kw: fn(a, x, **kw)
        plain, abs_run = tdir.banded_spmm_direct_reference, lambda fn: fn(a._replace(band=band.abs()), x.abs())
    else:
        q, wrow = bq.quantize_band(a), kid == "B2c-wrow-bf16"
        kernel, run = tv.banded_spmm_quant_fused_dot_kernel, lambda fn, **kw: fn(q, x, wrow, **kw)
        plain = tv.banded_spmm_quant_fused_dot_reference
        abs_run = lambda fn: fn(q._replace(band_q=q.band_q.abs()), x.abs(), wrow)  # noqa: E731
    before = kernel.launches
    got = run(kernel)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert got.shape == (n, F) and got.dtype == torch.float32
    want = run(plain)
    if kid != "B2c-wrow-bf16":
        assert bool(((got - want).abs() <= MAGNITUDE_RTOL * abs_run(plain)).all())
        want = run(plain, sum_dtype=torch.float64)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_fm_bf16_band_matches_plain_version(cuda, shape):
    nb, W, block, n, F = shape
    bandT, scales, x = operands(shape, cuda)
    xT = x.T.contiguous()
    before = fv.fm_bf16_band_kernel.launches
    got = fv.fm_bf16_band_kernel(bandT, scales, n, W, xT, rows_per_step=1)
    torch.cuda.synchronize()
    assert fv.fm_bf16_band_kernel.launches == before + 1
    want = fv.fm_bf16_band_reference(bandT, scales, n, W, xT, rows_per_step=1)
    assert got.shape == (F, n) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", [(20, 2, 256, 5000, 64), (7, 1, 100, 650, 70)])
def test_accumulation_over_six_decades(cuda, shape):
    """Row-major and feature-major, each output within 1e-5 of the sum of
    its products' magnitudes."""
    nb, W, block, n, F = shape
    band, scales, x = operands(shape, cuda, decades=3.0)
    a = BandedMatrix(band, n, W)
    got = tdir.banded_spmm_direct_kernel(a, x)
    want = tdir.banded_spmm_direct_reference(a, x)
    magnitude = tdir.banded_spmm_direct_reference(a._replace(band=band.abs()), x.abs())
    assert bool(((got - want).abs() <= MAGNITUDE_RTOL * magnitude).all())
    ones = torch.ones_like(scales)
    xT = x.T.contiguous()
    got = fv.fm_bf16_band_kernel(band, ones, n, W, xT, rows_per_step=1)
    want = fv.fm_bf16_band_reference(band, ones, n, W, xT, rows_per_step=1)
    magnitude = fv.fm_bf16_band_reference(band.abs(), ones, n, W, xT.abs(), rows_per_step=1)
    assert bool(((got - want).abs() <= MAGNITUDE_RTOL * magnitude).all())


def test_the_launch_alone_equals_the_wrapper(cuda):
    """On the operands the wrappers prepare, each role's launch gives the
    entry point's output bit for bit (the padding is the wrapper's only
    work besides the launch)."""
    shape = (7, 1, 100, 650, 70)
    nb, W, block, n, F = shape
    band, scales, x = operands(shape, cuda)
    a = BandedMatrix(band, n, W)
    band_p, frame = band_mma.rowmajor_operands(a, x)
    alone = band_mma.launch_rowmajor("K7", band_p, frame, n, W, block, F)
    assert torch.equal(alone, tdir.banded_spmm_direct(a, x))
    xT = x.T.contiguous()
    x_pad = fv.pad_xT(xT, n, nb, W, block)
    alone = band_mma.launch_fm("B3a", band_mma.pad_band(band), scales,
                               band_mma.fm_frame(x_pad, nb, W, block), W, block)
    assert torch.equal(alone[:, :n], fv.fm_bf16_band(band, scales, n, W, xT, rows_per_step=7))
    a32 = BandedMatrix(band.to(torch.float32), n, W)
    band_p, frames = band_mma.rowmajor_operands(a32, x)
    alone = band_mma.launch_rowmajor("K7", band_p, frames, n, W, block, F)
    assert torch.equal(alone, tdir.banded_spmm_direct(a32, x))
    q = bq.quantize_band(a32)
    frame = band_mma.rowmajor_frame(x, n, nb, W, block)
    for wrow in (False, True):
        alone = band_mma.launch_rowmajor("B2c", band_mma.pad_band(q.band_q), frame, n, W, block, F,
                                         q.scales, wrow_bf16=wrow)
        assert torch.equal(alone, tv.banded_spmm_quant_fused_dot(q, x, wrow))


def test_wrappers_refuse_what_the_body_does_not_take(cuda):
    band, scales, x = operands((7, 1, 100, 650, 70), cuda)
    with pytest.raises(ValueError, match="rows_per_step"):
        fv.fm_bf16_band_kernel(band, scales, 650, 1, x.T.contiguous(), rows_per_step=2)
    with pytest.raises(ValueError, match="padded band"):
        band_mma.launch_rowmajor("K7", band, band_mma.rowmajor_frame(x, 650, 7, 1, 100), 650, 1, 100, 70)
    band_p = band_mma.pad_band(band)
    with pytest.raises(ValueError, match="frame"):
        band_mma.launch_rowmajor("K7", band_p, torch.zeros((9, 112, 72), device=cuda), 650, 1, 100, 70)
