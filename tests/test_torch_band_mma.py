"""What the wrappers of the tensor-core band body (``ops/band_mma.py``,
``csrc/band_mma.cu``) add around the kernel, on the CPU.

The kernel runs only on the card (``tests/test_torch_band_mma_cuda.py``).
Here its function is computed in plain torch on the operands the wrappers
prepare (the band and the frame padded with zeros to a block that is a
multiple of 16 and, row-major, to features that are a multiple of 8), and
sliced back to the caller's block and features.  That equals the plain
versions on the original operands within rtol / atol 1e-6: the extra zero
senders change no sum, but they can change how the CPU's ``bmm`` blocks
its sums, so their order.  The shapes are those ``chip_smoke.py`` checks
the kernels at (a block of 100, F = 1, 5 and 70, W = 0, ragged tails), and
the feature-major ones with a block of 100 and F = 70 besides.  The
row-major frame is bitwise the ``x_pad`` that ``banded_pallas.py:45-48``
hands its ``pallas_call``, computed here by JAX on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from connectome_gnn_tpu_torch.ops import band_mma
from connectome_gnn_tpu_torch.ops import banded_direct as tdir
from connectome_gnn_tpu_torch.ops import fm_variants as fv
from connectome_gnn_tpu_torch.ops.banded import BandedMatrix

RTOL, ATOL = 1e-6, 1e-6
#: (num_blocks, W, block, num_nodes, F): chip_smoke.py's BAND_SHAPES
BAND_SHAPES = [(10, 1, 64, 640, 16), (10, 1, 64, 600, 16), (10, 0, 64, 600, 16),
               (10, 1, 64, 600, 5), (10, 2, 64, 640, 1), (7, 1, 100, 650, 70),
               (16, 2, 256, 4000, 64)]
#: (num_blocks, W, block, num_nodes, F, R): chip_smoke.py's FM_SHAPES, then a
#: block of 100 with F = 70 and a block of 40 with F = 5
FM_SHAPES = [(8, 1, 64, 512, 16, 4), (12, 0, 64, 700, 16, 2), (12, 2, 64, 768, 5, 4),
             (8, 1, 64, 500, 1, 2), (8, 2, 64, 512, 64, 4), (7, 1, 100, 650, 70, 7),
             (6, 0, 40, 230, 5, 3)]


def random_band(shape, seed):
    """A random non-symmetric bfloat16 band (70 % zeros) and activations."""
    nb, W, block, n, F = shape[:5]
    rng = np.random.default_rng(seed)
    dims = (nb, 2 * W + 1, block, block)
    band = (rng.standard_normal(dims) * (rng.random(dims) < 0.3)).astype(np.float32)
    x = rng.standard_normal((n, F)).astype(np.float32)
    return torch.from_numpy(band).to(torch.bfloat16), torch.from_numpy(x), rng


def shape_id(shape):
    return "nb{}-W{}-b{}-n{}-F{}".format(*shape[:5])


@pytest.mark.parametrize("shape", BAND_SHAPES, ids=shape_id)
def test_rowmajor_padding_matches_the_plain_version(shape):
    nb, W, block, n, F = shape
    band, x, _ = random_band(shape, seed=sum(shape))
    a = BandedMatrix(band, n, W)
    band_p, frame = band_mma.rowmajor_operands(a, x)
    bp, Fp = band_mma.padded(block, 16), band_mma.padded(F, 8)
    assert band_p.shape == (nb, 2 * W + 1, bp, bp) and frame.shape == (nb + 2 * W, bp, Fp)
    assert band_p.dtype == frame.dtype == torch.bfloat16
    got = band_mma.rowmajor_on_operands(band_p, frame, n, W, block, F)
    want = tdir.banded_spmm_direct_reference(a, x)
    assert got.shape == (n, F)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", FM_SHAPES, ids=shape_id)
def test_feature_major_padding_matches_the_plain_version(shape):
    nb, W, block, n, F, R = shape
    bandT, x, rng = random_band(shape, seed=sum(shape))
    scales = torch.from_numpy(rng.uniform(1e-3, 1.1e-2, (nb, 2 * W + 1)).astype(np.float32))
    xT = x.T.contiguous()
    x_pad = fv.pad_xT(xT, n, nb, W, block)
    band_p, x_pad_p = band_mma.pad_band(bandT), band_mma.fm_frame(x_pad, nb, W, block)
    bp = band_mma.padded(block, 16)
    assert band_p.shape == (nb, 2 * W + 1, bp, bp) and x_pad_p.shape == (F, (nb + 2 * W) * bp)
    got = band_mma.fm_on_operands(band_p, scales, x_pad_p, W, block)[:, :n]
    want = fv.fm_bf16_band_reference(bandT, scales, n, W, xT, R)
    assert got.shape == (F, n)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", BAND_SHAPES, ids=shape_id)
def test_rowmajor_frame_is_the_jax_wrappers_x_pad(shape):
    """``x[:n]`` cast to bfloat16 and padded as ``banded_pallas.py:45-48``
    does, bitwise; the block and feature padding beyond it is zero."""
    nb, W, block, n, F = shape
    _, x, _ = random_band(shape, seed=sum(shape))
    xj = jnp.asarray(x.numpy())
    x_pad = jnp.pad(xj[:n].astype(jnp.bfloat16),
                    ((W * block, nb * block - n + W * block), (0, 0))).reshape(nb + 2 * W, block, F)
    frame = band_mma.rowmajor_frame(x, n, nb, W, block)
    inner = frame[:, :block, :F].to(torch.float32).numpy()
    np.testing.assert_array_equal(inner, np.asarray(x_pad.astype(jnp.float32)))
    outside = frame.clone()
    outside[:, :block, :F] = 0
    assert not bool(outside.any())


def test_padding_is_a_no_op_at_the_main_shape():
    """At b = 256 and F = 64 the wrappers pass the band and the feature-major
    frame through as they are, and build the row-major frame in one pass."""
    band = torch.zeros((2, 5, 256, 256), dtype=torch.bfloat16)
    x_pad = torch.zeros((64, 6 * 256), dtype=torch.bfloat16)
    assert band_mma.pad_band(band) is band
    assert band_mma.fm_frame(x_pad, 2, 2, 256) is x_pad
    frame = band_mma.rowmajor_frame(torch.ones((500, 64)), 500, 2, 2, 256)
    assert frame.shape == (6, 256, 64) and int(frame.to(torch.float32).sum()) == 500 * 64
