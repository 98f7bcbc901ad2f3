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

K3 runs role A over its int8 band with one scale per tile.  On K3's
prepared operands (the int8 band through :func:`pad_band`, x through
:func:`rowmajor_frame`) role A's function with those scales equals K3's
plain version on the original operands and JAX's ``banded_spmm_quant`` in
interpret mode, at rtol 1e-5 / atol 1e-5 (JAX's own kernel-versus-emulation
gate: the same exact products, float32 sums in another order), at a block
of 100 (padded to 112) and of 16, F = 5 and F = 1 (padded to 8), W = 0,
ragged tails and F = 130 (three feature units of the kernel).

K7 over a float32 band runs role A on bfloat16 products: the kernel splits
each band value, and :func:`split_bf16x3` each ``x`` value, exactly into
three bfloat16 terms, bitwise as the kernel's register code does (a numpy
emulation by bit operations, over ±30 decades, zeros, signs and ties), and
sums six of the nine products.  Summed in float64, so that no float32 sum
order enters, the six stay within rtol / atol 1e-6 of the float64 product
of the float32 operands at the (16, 2, 256, 4000, 64) shape; three (the
products of hi and mid alone) break 1e-5 there, which is why six are
taken.  Accumulated in float32 at each 16-sender k-step, as the tensor
cores accumulate, the five small products keep that gate only in a
fragment of their own: added into the tile's dot they round at its
magnitude and break it.  The float32 band's prepared operands (the padded
band and the three frames) give the float64 product at 1e-6 at every
shape.

B2c runs role A over K3's operands.  With ``wrow_bf16`` the kernel folds
each scale into its tile as it widens the int8 entries; that fold,
emulated by bit operations, is the plain version's ``bf16(fl(scale · q))``
bit for bit.  Without it the kernel takes K3's order, which holds 1e-5 of
the plain version's fold summed in float64 (``sum_dtype=torch.float64``);
at the 4000-node shape the plain float32 versions of K7 over a float32
band and of B2c do not, by their own rounding, which is why the card tests
hold those two kernels to the float64 sums.

K4 and K6 run role B over the int8 band of transposed tiles.  On their
prepared operands (the int8 band through :func:`pad_band`; K4's ``xT``
itself where TMA takes it, else one padded copy, and K6's blocked frame,
through :func:`fm_x_operand` and :func:`blocked_x_operand`; the frame as
K4's tensor map reads it, zero below sender 0 and past ``num_nodes``) role
B's function, ``x`` rounded to bfloat16, equals K4's and K6's plain
versions and JAX's ``banded_spmm_quant_fm`` / ``banded_spmm_quant_blocked``
in interpret mode at rtol 1e-5 / atol 1e-5, at blocks of 100 and 16, W = 0,
F = 1, F = 130 and ``num_nodes`` not a multiple of 4.  Two numpy emulations
hold the kernel's shared-memory address maps: the widening (a 128-byte
swizzled int8 box read as 16-byte chunks, ``widen2`` by bit operations, and
the two swizzled bfloat16 boxes written from it) gives the tile's entries
at the positions the B descriptor reads, each bank met once a quarter
warp; and each thread's A fragment reads the right senders of the
swizzled float32 frame boxes, and of B3c's and B3d's bfloat16 frame box
(each bank once a warp).  K4's 64-sender stages, emulated in numpy over
the operands its wrapper prepares at blocks of 16, 48 and 40 (padded
copy), carry an Inf of x past its node block into row blocks that the
plain version keeps finite, unless the k-steps at or past b' are set to
zero as the kernel does; with that mask they give the plain version, NaN
for NaN.

B2b runs role A over the int8 band on K5's ``s8 × s8`` products and K5's
int8 frame, which its wrapper builds feature-major from the node-major
quantization.  A numpy emulation of its A-fragment loads from the swizzled
receiver-major box rebuilds the tile, one 32-bit load a register and one
wavefront a warp load.  On its prepared operands (the padded band, the
transposed and padded int8 frame) its function equals the plain version
bit for bit at blocks of 16, 40 (padded to 48) and 48, W = 0, 1, 2, F = 1,
5 and 130 and a ragged tail, and at the saturated dot of 127²·256.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import connectome_gnn_tpu.ops.banded_quant as jq
from connectome_gnn_tpu_torch.ops import band_mma
from connectome_gnn_tpu_torch.ops import band_variants as tv
from connectome_gnn_tpu_torch.ops import banded_direct as tdir
from connectome_gnn_tpu_torch.ops import banded_quant as tq
from connectome_gnn_tpu_torch.ops import fm_variants as fv
from connectome_gnn_tpu_torch.ops.banded import BandedMatrix, pad_blocks

RTOL, ATOL = 1e-6, 1e-6
#: K3 against its plain version and JAX's kernel: JAX's own gate
K3_RTOL, K3_ATOL = 1e-5, 1e-5
#: (num_blocks, W, block, num_nodes, F) for K3's int8 band: a block of 100
#: and of 16, F = 5 and 1, W = 0, ragged tails, F = 130
K3_SHAPES = [(7, 1, 100, 650, 70), (10, 2, 64, 600, 5), (10, 2, 64, 640, 1), (10, 0, 64, 600, 16),
             (6, 1, 64, 350, 130), (12, 1, 16, 180, 8)]
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
    """At b = 256 and F = 64 the wrappers pass the band (bfloat16 or K3's
    int8) and the feature-major frame through as they are, and build the
    row-major frame in one pass."""
    band = torch.zeros((2, 5, 256, 256), dtype=torch.bfloat16)
    x_pad = torch.zeros((64, 6 * 256), dtype=torch.bfloat16)
    assert band_mma.pad_band(band) is band
    band_q = torch.zeros((2, 5, 256, 256), dtype=torch.int8)
    assert band_mma.pad_band(band_q) is band_q
    assert band_mma.fm_frame(x_pad, 2, 2, 256) is x_pad
    frame = band_mma.rowmajor_frame(torch.ones((500, 64)), 500, 2, 2, 256)
    assert frame.shape == (6, 256, 64) and int(frame.to(torch.float32).sum()) == 500 * 64
    # K4 reads the caller's float32 xT, K6 its padded blocked frame, as they are
    xT = torch.zeros((64, 512))
    x, x_block, x_cols = band_mma.fm_x_operand(xT, 500, 2, 256)
    assert x is xT and (x_block, x_cols) == (256, 500)
    xb_pad = torch.zeros((6, 64, 256))
    assert band_mma.blocked_x_operand(xb_pad, 256) is xb_pad


def random_quantized(shape, seed):
    """A random non-symmetric int8 band (70 % zeros, tile (0, 0) all zero
    with scale 1), its per-tile scales and activations, as numpy."""
    nb, W, block, n, F = shape
    rng = np.random.default_rng(seed)
    dims = (nb, 2 * W + 1, block, block)
    q = (rng.integers(-127, 128, dims) * (rng.random(dims) < 0.3)).astype(np.int8)
    scales = rng.uniform(1e-3, 1.1e-2, dims[:2]).astype(np.float32)
    q[0, 0], scales[0, 0] = 0, 1.0
    return q, scales, rng.standard_normal((n, F)).astype(np.float32)


def k3_on_operands(q: tq.QuantizedBandedMatrix, x: torch.Tensor) -> torch.Tensor:
    """Role A with per-dot scales on the operands K3's wrapper prepares."""
    nb, W, block, n = q.num_blocks, q.bandwidth, q.block, q.num_nodes
    band_p, frame = band_mma.pad_band(q.band_q), band_mma.rowmajor_frame(x, n, nb, W, block)
    bp, Fp = band_mma.padded(block, 16), band_mma.padded(x.shape[1], 8)
    assert band_p.dtype == torch.int8 and band_p.shape == (nb, 2 * W + 1, bp, bp)
    assert frame.dtype == torch.bfloat16 and frame.shape == (nb + 2 * W, bp, Fp)
    return band_mma.rowmajor_on_operands(band_p, frame, n, W, block, x.shape[1], q.scales)


@pytest.mark.parametrize("shape", K3_SHAPES, ids=shape_id)
def test_rowmajor_int8_band_with_scales_matches_k3s_plain_version(shape):
    q, scales, x = random_quantized(shape, seed=sum(shape))
    tqq = tq.QuantizedBandedMatrix(torch.from_numpy(q), torch.from_numpy(scales), shape[3], shape[1])
    got = k3_on_operands(tqq, torch.from_numpy(x))
    want = tq.banded_spmm_quant_reference(tqq, torch.from_numpy(x))
    assert got.shape == (shape[3], shape[4])
    torch.testing.assert_close(got, want, rtol=K3_RTOL, atol=K3_ATOL)


@pytest.mark.parametrize("shape", K3_SHAPES, ids=shape_id)
def test_rowmajor_int8_band_with_scales_matches_jax_interpret(shape):
    q, scales, x = random_quantized(shape, seed=sum(shape))
    n, W = shape[3], shape[1]
    tqq = tq.QuantizedBandedMatrix(torch.from_numpy(q), torch.from_numpy(scales), n, W)
    jqq = jq.QuantizedBandedMatrix(jnp.asarray(q), jnp.asarray(scales), n, W)
    want = np.asarray(jq.banded_spmm_quant(jqq, jnp.asarray(x), interpret=True))
    np.testing.assert_allclose(k3_on_operands(tqq, torch.from_numpy(x)).numpy(), want,
                               rtol=K3_RTOL, atol=K3_ATOL)


# ---------------------------------------------------------------------------
# K7 over a float32 band: the exact three-way bfloat16 split
# ---------------------------------------------------------------------------

#: the card tests' largest shape, where the float32 sums cancel most
BIG = (16, 2, 256, 4000, 64)
#: the six products against the float64 product, and the gate three miss
SPLIT_RTOL, SPLIT_ATOL = 1e-6, 1e-6
GATE = 1e-5


def bf16_bits(a: np.ndarray) -> np.ndarray:
    """float32 → the nearest bfloat16 (ties to even) by bit operations, as
    ``cvt.rn.bf16x2.f32`` rounds, returned as float32."""
    u = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(np.uint32).view(np.float32)


def split_bits(a: np.ndarray):
    """The kernel's register split (``split3``): rn, float32 subtraction,
    rn, float32 subtraction, rn."""
    hi = bf16_bits(a)
    rest = (a - hi).astype(np.float32)
    mid = bf16_bits(rest)
    return hi, mid, bf16_bits((rest - mid).astype(np.float32))


def split_cases(case: str, rng) -> np.ndarray:
    if case == "decades":
        mag = 10.0 ** rng.uniform(-30, 30, 20000)
        return (rng.choice([-1.0, 1.0], 20000) * mag).astype(np.float32)
    if case == "zeros-and-signs":
        return np.array([0.0, -0.0, 1.0, -1.0, 3.3895314e38, -3.3895314e38, 1e-30, -1e-30,
                         1.0 + 2.0 ** -23, -(1.0 + 2.0 ** -23), 2.0 ** -100, np.pi, -np.e],
                        dtype=np.float32)
    # ties: at hi (low 16 bits 0x8000), at mid (the rest one half-unit past
    # 8 significant bits), and one past either, with even and odd mantissas;
    # magnitudes from 2^-100 (the split is exact down to about 2^-110)
    upper = rng.integers(27 << 7, 0x7F00, 4000, dtype=np.uint32) << 16
    m = rng.integers(0, 128, 4000, dtype=np.uint32)
    low = np.concatenate([np.full(4000, 0x8000), 0x4000 | (m << 7) | 0x40,
                          0x4000 | (m << 7) | 0x41, np.full(4000, 0x8001)]).astype(np.uint32)
    bits = np.tile(upper, 4) | low
    bits[::2] |= np.uint32(0x80000000)
    return bits.view(np.float32)


@pytest.mark.parametrize("case", ["decades", "zeros-and-signs", "ties"])
def test_split_bf16x3_is_exact_and_the_kernels_split(case):
    x = split_cases(case, np.random.default_rng(7))
    parts = band_mma.split_bf16x3(torch.from_numpy(x))
    assert parts.dtype == torch.bfloat16 and parts.shape == (3, *x.shape)
    got = [(p.view(torch.int16).numpy().view(np.uint16).astype(np.uint32) << 16).view(np.float32)
           for p in parts]
    for g, want in zip(got, split_bits(x)):
        np.testing.assert_array_equal(g.view(np.uint32), want.view(np.uint32))
    total = sum(g.astype(np.float64) for g in got)
    np.testing.assert_array_equal(total, x.astype(np.float64))


def split_sum(band: torch.Tensor, x: torch.Tensor, W: int, products) -> torch.Tensor:
    """``Σ_d Σ_(i, j) band_i @ x_j`` over the split terms in ``products``,
    in float64, on the unpadded operands (``n`` = all rows of ``x``)."""
    nb, block = band.shape[0], band.shape[2]
    parts = band_mma.split_bf16x3(band).to(torch.float64)
    xs = band_mma.split_bf16x3(x).to(torch.float64)
    frames = torch.stack([pad_blocks(xs[j], nb, W, block) for j in range(3)])
    out = torch.zeros((nb, block, x.shape[1]), dtype=torch.float64)
    for d in range(2 * W + 1):
        for i, j in products:
            out += torch.bmm(parts[i][:, d], frames[j][d : d + nb])
    return out.reshape(nb * block, -1)[: x.shape[0]]


def float_band(shape, decades=0.0):
    """A random non-symmetric float32 band (70 % zeros, tile (0, 0) all
    zero) and activations, as the card tests draw them; with ``decades``
    their magnitudes spread log-uniformly over that many decades each way."""
    nb, W, block, n, F = shape
    rng = np.random.default_rng(sum(shape))
    dims = (nb, 2 * W + 1, block, block)
    band = rng.standard_normal(dims) * (rng.random(dims) < 0.3)
    band[0, 0] = 0
    x = np.random.default_rng(n + F).standard_normal((n, F))
    if decades:
        band *= 10.0 ** rng.uniform(-decades, decades, dims)
        x *= 10.0 ** rng.uniform(-decades, decades, (n, F))
    return (BandedMatrix(torch.from_numpy(band.astype(np.float32)), n, W),
            torch.from_numpy(x.astype(np.float32)))


def test_six_split_products_hold_the_float64_product():
    a, x = float_band(BIG)
    want = tdir.banded_spmm_direct_reference(a, x, sum_dtype=torch.float64).to(torch.float64)
    six = split_sum(a.band, x, a.bandwidth, band_mma.SPLIT_PRODUCTS)
    torch.testing.assert_close(six, want, rtol=SPLIT_RTOL, atol=SPLIT_ATOL)
    three = split_sum(a.band, x, a.bandwidth, [(0, 0), (0, 1), (1, 0)])
    assert not torch.allclose(three, want, rtol=GATE, atol=GATE)


def test_six_split_products_over_six_decades():
    """Band and x spread over three decades each way, where cancelling
    sums make a relative gate meaningless: each output of the six products
    within 2^-22 of the sum of its products' magnitudes, ``|A| @ |x|`` (the
    three left out are under 2^-25 of it together, and the reference's one
    rounding to float32 under 2^-24)."""
    a, x = float_band(BIG, decades=3.0)
    want = tdir.banded_spmm_direct_reference(a, x, sum_dtype=torch.float64).to(torch.float64)
    magnitude = tdir.banded_spmm_direct_reference(a._replace(band=a.band.abs()), x.abs(),
                                                  sum_dtype=torch.float64).to(torch.float64)
    six = split_sum(a.band, x, a.bandwidth, band_mma.SPLIT_PRODUCTS)
    assert bool(((six - want).abs() <= 2.0 ** -22 * magnitude).all())


def k_step_fragments(a: BandedMatrix, x: torch.Tensor, own_fragment: bool) -> torch.Tensor:
    """The kernel's sums with float32 accumulation rounded to nearest at
    every 16-sender k-step: hi·hi into each tile's dot and the five small
    products into a fragment of the unit's own (``own_fragment``) or into
    the tile's dot; each dot then into the float32 sum."""
    nb, W, block, n = a.num_blocks, a.bandwidth, a.block, a.num_nodes
    parts = band_mma.split_bf16x3(a.band).to(torch.float64)
    xs = band_mma.split_bf16x3(x).to(torch.float64)
    frames = [pad_blocks(xs[j], nb, W, block) for j in range(3)]
    acc = torch.zeros((nb, block, x.shape[1]), dtype=torch.float32)
    corr = torch.zeros_like(acc)
    for d in range(2 * W + 1):
        dot = torch.zeros_like(acc)
        for k in range(0, block, 16):
            for i, j in band_mma.SPLIT_PRODUCTS:
                g = torch.bmm(parts[i][:, d, :, k : k + 16], frames[j][d : d + nb, k : k + 16])
                if (i, j) == (0, 0) or not own_fragment:
                    dot = (dot.to(torch.float64) + g).to(torch.float32)
                else:
                    corr = (corr.to(torch.float64) + g).to(torch.float32)
        acc += dot
    return (acc + corr).reshape(nb * block, -1)[:n]


def test_small_products_need_a_fragment_of_their_own():
    a, x = float_band(BIG)
    want = tdir.banded_spmm_direct_reference(a, x, sum_dtype=torch.float64)
    torch.testing.assert_close(k_step_fragments(a, x, True), want, rtol=GATE, atol=GATE)
    assert not torch.allclose(k_step_fragments(a, x, False), want, rtol=GATE, atol=GATE)


@pytest.mark.parametrize("shape", BAND_SHAPES, ids=shape_id)
def test_float32_band_operands_give_the_float64_product(shape):
    nb, W, block, n, F = shape
    a, x = float_band(shape)
    band_p, frames = band_mma.rowmajor_operands(a, x)
    bp, Fp = band_mma.padded(block, 16), band_mma.padded(F, 8)
    assert band_p.dtype == torch.float32 and band_p.shape == (nb, 2 * W + 1, bp, bp)
    assert frames.dtype == torch.bfloat16 and frames.shape == (3, nb + 2 * W, bp, Fp)
    x_hat = frames.to(torch.float64).sum(0)[W : W + nb, :block, :F].reshape(nb * block, F)
    assert torch.equal(x_hat[:n], x.to(torch.float64)) and not bool(x_hat[n:].any())
    got = band_mma.rowmajor_on_operands(band_p, frames, n, W, block, F)
    want = tdir.banded_spmm_direct_reference(a, x, sum_dtype=torch.float64)
    assert got.shape == (n, F)
    torch.testing.assert_close(got, want, rtol=SPLIT_RTOL, atol=SPLIT_ATOL)


@pytest.mark.parametrize("kid", ["K7-f32", "B2c"])
def test_the_float32_plain_version_misses_its_float64_sums_at_the_4000_node_shape(kid):
    """The reason the card tests hold these two kernels to the float64
    sums: at random data with cancelling sums, the plain version's own
    float32 rounding exceeds the 1e-5 gate, so any other order of sums,
    exact or not, can differ from it by more."""
    a, x = float_band(BIG)
    if kid == "K7-f32":
        plain, want = (tdir.banded_spmm_direct_reference(a, x, sum_dtype=t)
                       for t in (torch.float32, torch.float64))
    else:
        q = tq.quantize_band(a)
        plain, want = (tv.banded_spmm_quant_fused_dot_reference(q, x, sum_dtype=t)
                       for t in (torch.float32, torch.float64))
    assert not torch.allclose(plain, want, rtol=GATE, atol=GATE)


# ---------------------------------------------------------------------------
# B2c over K3's operands
# ---------------------------------------------------------------------------


def fold_bits(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """The kernel's ``fold2``: each int8, its sign bit flipped, as the
    float32 2^23 + q + 128, less 2^23 + 128 (exact), times the scale in
    float32, rounded to bfloat16 by bit operations."""
    u = (q.astype(np.int16).view(np.uint16).astype(np.uint32) & 0xFF) ^ 0x80
    widened = (u | 0x4B000000).view(np.float32) - np.float32(8388736.0)
    return bf16_bits((widened * scale).astype(np.float32))


def test_wrow_bf16_fold_is_the_plain_versions_bit_for_bit():
    rng = np.random.default_rng(3)
    q = np.arange(-128, 128, dtype=np.int8)[None, :]
    scales = np.concatenate([10.0 ** rng.uniform(-3, 3, 500), rng.uniform(1e-3, 1.1e-2, 500),
                             [1.0, 2.0 ** -7, 1.0 / 127]]).astype(np.float32)[:, None]
    band_q = torch.from_numpy(np.broadcast_to(q, (scales.shape[0], 256)).copy())[:, None, None, :]
    folded = band_mma.fold_bf16(band_q, torch.from_numpy(scales))
    plain = (torch.from_numpy(scales)[:, :, None, None] * band_q.to(torch.float32)).to(torch.bfloat16)
    assert torch.equal(folded.view(torch.int16), plain.view(torch.int16))
    got = (folded.view(torch.int16).numpy().view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    want = fold_bits(q, scales)
    np.testing.assert_array_equal(got.reshape(want.shape).view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("wrow_bf16", [False, True], ids=["k3-order", "wrow-bf16"])
@pytest.mark.parametrize("shape", K3_SHAPES + [BIG], ids=shape_id)
def test_b2c_on_k3s_operands_holds_its_plain_version(shape, wrow_bf16):
    """Role A over K3's prepared operands, the scale on each tile's dot or
    folded into the tile, against B2c's plain fold summed in float64 at
    the card tests' 1e-5 gate."""
    a, x = float_band(shape)
    q = tq.quantize_band(a)
    nb, W, block, n, F = shape
    band_p, frame = band_mma.pad_band(q.band_q), band_mma.rowmajor_frame(x, n, nb, W, block)
    got = band_mma.rowmajor_on_operands(band_p, frame, n, W, block, F, q.scales, wrow_bf16)
    want = tv.banded_spmm_quant_fused_dot_reference(q, x, wrow_bf16, sum_dtype=torch.float64)
    assert got.shape == (n, F)
    torch.testing.assert_close(got, want, rtol=GATE, atol=GATE)


def test_k7_f32_and_b2c_launch_the_tensor_core_body():
    """Their C entry points, and K4's, K6's and B2b's, are defined in
    ``csrc/band_mma.cu`` and in no other source; the CUDA-core band body
    that once held them, ``csrc/banded_spmm.cu``, is gone."""
    import os

    csrc = os.path.join(os.path.dirname(band_mma.__file__), "..", "csrc")
    text = {f: open(os.path.join(csrc, f)).read() for f in sorted(os.listdir(csrc)) if f.endswith(".cu")}
    for entry in ("cgt_banded_spmm_direct_f32", "cgt_banded_spmm_quant_fused_dot",
                  "cgt_banded_spmm_quant_fm", "cgt_banded_spmm_quant_blocked",
                  "cgt_banded_spmm_w8a8_rowmajor"):
        assert f"int {entry}(" in text["band_mma.cu"]
        assert not [f for f, t in text.items() if f != "band_mma.cu" and f"int {entry}(" in t]
    assert "banded_spmm.cu" not in text
    assert not [f for f, t in text.items() if "__dp4a" in t]


# ---------------------------------------------------------------------------
# K4 and K6: role B over the int8 band
# ---------------------------------------------------------------------------

#: (num_blocks, W, block, num_nodes, F): a block of 100 (padded to 112; x
#: copied), of 16, W = 0, F = 1, F = 130 (three feature units), num_nodes
#: not a multiple of 4 at a block of 64 (x's row stride: copied), and
#: shapes where the kernel reads xT as it is
FM_INT8_SHAPES = [(7, 1, 100, 650, 70), (12, 1, 16, 180, 8), (10, 0, 64, 600, 16),
                  (10, 2, 64, 640, 1), (6, 1, 64, 350, 130), (10, 2, 64, 603, 5)]


def fm_int8_operands(shape):
    """K4's and K6's operands as torch and JAX pairs: the feature-major int8
    band, ``xT [F, n]`` and a random padded blocked frame."""
    q, scales, x = random_quantized(shape, seed=sum(shape) + 1)
    nb, W, block, n, F = shape
    qT = np.ascontiguousarray(np.swapaxes(q, 2, 3))
    xb_pad = np.random.default_rng(n + F).standard_normal((nb + 2 * W, F, block)).astype(np.float32)
    tqf = tq.QuantizedBandedMatrixFM(torch.from_numpy(qT), torch.from_numpy(scales), n, W)
    jqf = jq.QuantizedBandedMatrixFM(jnp.asarray(qT), jnp.asarray(scales), n, W)
    return tqf, jqf, np.ascontiguousarray(x.T), xb_pad


def k4_on_operands(q: tq.QuantizedBandedMatrixFM, xT: torch.Tensor) -> torch.Tensor:
    """Role B over the int8 band on the operands K4's wrapper prepares, x read
    as its 2-D tensor map reads it."""
    nb, W, block, n = q.num_blocks, q.bandwidth, q.block, q.num_nodes
    band_p = band_mma.pad_band(q.band_qT)
    x, x_block, x_cols = band_mma.fm_x_operand(xT, n, nb, block)
    copied = block % 16 != 0 or xT.stride(0) % 4 != 0
    assert (x is not xT) == copied and x.dtype == torch.float32
    frame = band_mma.fm_window_frame(x, x_block, x_cols, nb, W, band_p.shape[2])
    return band_mma.fm_on_operands(band_p, q.scales, frame, W, block)[:, :n]


def k6_on_operands(q: tq.QuantizedBandedMatrixFM, xb_pad: torch.Tensor) -> torch.Tensor:
    band_p = band_mma.pad_band(q.band_qT)
    xb = band_mma.blocked_x_operand(xb_pad, q.block)
    assert (xb is xb_pad) == (q.block % 16 == 0)
    return band_mma.blocked_on_operands(band_p, q.scales, xb, q.bandwidth, q.block)


@pytest.mark.parametrize("shape", FM_INT8_SHAPES, ids=shape_id)
def test_k4_on_its_operands_matches_its_plain_version(shape):
    tqf, _, xT, _ = fm_int8_operands(shape)
    got = k4_on_operands(tqf, torch.from_numpy(xT))
    assert got.shape == (shape[4], shape[3])
    torch.testing.assert_close(got, tq.banded_spmm_quant_fm_reference(tqf, torch.from_numpy(xT)),
                               rtol=K3_RTOL, atol=K3_ATOL)


@pytest.mark.parametrize("shape", FM_INT8_SHAPES, ids=shape_id)
def test_k4_on_its_operands_matches_jax_interpret(shape):
    tqf, jqf, xT, _ = fm_int8_operands(shape)
    want = np.asarray(jq.banded_spmm_quant_fm(jqf, jnp.asarray(xT), interpret=True))
    np.testing.assert_allclose(k4_on_operands(tqf, torch.from_numpy(xT)).numpy(), want,
                               rtol=K3_RTOL, atol=K3_ATOL)


@pytest.mark.parametrize("shape", FM_INT8_SHAPES, ids=shape_id)
def test_k6_on_its_operands_matches_its_plain_version(shape):
    tqf, _, _, xb_pad = fm_int8_operands(shape)
    got = k6_on_operands(tqf, torch.from_numpy(xb_pad))
    assert got.shape == (shape[0], shape[4], shape[2])
    torch.testing.assert_close(got, tq.banded_spmm_quant_blocked_reference(tqf, torch.from_numpy(xb_pad)),
                               rtol=K3_RTOL, atol=K3_ATOL)


@pytest.mark.parametrize("shape", FM_INT8_SHAPES, ids=shape_id)
def test_k6_on_its_operands_matches_jax_interpret(shape):
    tqf, jqf, _, xb_pad = fm_int8_operands(shape)
    want = np.asarray(jq.banded_spmm_quant_blocked(jqf, jnp.asarray(xb_pad), interpret=True))
    np.testing.assert_allclose(k6_on_operands(tqf, torch.from_numpy(xb_pad)).numpy(), want,
                               rtol=K3_RTOL, atol=K3_ATOL)


def test_k4_copies_x_only_where_tma_cannot_take_it():
    """A strided view whose row stride is a multiple of 4 elements is read as
    it is; a base that is not 16-byte aligned, or a row stride that is not
    a multiple of 4, gets one padded copy, which the map reads as the same
    frame."""
    wide, odd = torch.randn(5, 700), torch.randn(5, 601)
    for view, copied in ((wide[:, :600], False), (wide[:, 1:601], True), (odd[:, :600], True)):
        x, x_block, x_cols = band_mma.fm_x_operand(view, 600, 10, 64)
        assert (x is not view) == copied, (view.stride(), view.data_ptr() % 16)
        want = band_mma.fm_window_frame(view.contiguous(), 64, 600, 10, 1, 64)
        assert want.shape == (5, 12 * 64)
        torch.testing.assert_close(band_mma.fm_window_frame(x, x_block, x_cols, 10, 1, 64), want,
                                   rtol=0, atol=0)


def swizzled(row, byte):
    """Byte ``byte`` of row ``row`` of a box of 128-byte rows under TMA's
    128-byte swizzle: 16-byte chunk c of row r at chunk c ^ (r % 8)."""
    return row * 128 + (((byte >> 4) ^ (row % 8)) << 4) + (byte & 15)


def widen2_bits(v: np.ndarray) -> np.ndarray:
    """The kernel's ``widen2`` by bit operations: bytes 0 and 1 of ``v`` to
    ``__byte_perm``'s halves, 128 plus the low seven bits (``m``) less 128,
    or 256 for a negative byte (``c``), as bf16x2."""
    v = v.astype(np.uint32)
    s = (v & 0xFF) | (((v >> 8) & 0xFF) << 16)
    m = (s & 0x007F007F) | 0x43004300
    c = (s & 0x00800080) | 0x43004300
    half = lambda h: ((h & 0xFFFF) << 16).view(np.float32)  # noqa: E731
    lo, hi = half(m) - half(c), half(m >> 16) - half(c >> 16)
    return (bf16_bits(lo).view(np.uint32) >> 16) | (bf16_bits(hi).view(np.uint32) & 0xFFFF0000)


@pytest.mark.parametrize("seed", [0, 1])
def test_widening_writes_the_box_the_b_descriptor_reads(seed):
    """A stage's int8 box (64 senders by 128 receivers, 128-byte swizzled as
    TMA writes it): each warpgroup's 128 threads widen its 64 receivers as
    the kernel does, and the bfloat16 box holds tile[s, 64 group + r] at
    byte swizzled(s, 2 r), where the B descriptor of the bfloat16 band's box
    reads it; every chunk is written once, and the eight threads of a
    quarter warp meet eight distinct chunks (each bank once)."""
    tile = np.random.default_rng(seed).integers(-128, 128, (64, 128)).astype(np.int8)
    if seed == 1:
        tile[0, :] = np.arange(-128, 0)  # every negative byte
    s_idx, r_idx = np.meshgrid(np.arange(64), np.arange(128), indexing="ij")
    box = np.zeros(64 * 128, np.uint8)
    box[swizzled(s_idx, r_idx)] = tile.view(np.uint8)
    for group in range(2):
        wide = np.zeros(64 * 128, np.uint8)
        written = np.zeros(64 * 128 // 16, np.int64)
        chunks = {}
        for t in range(128):
            wj, ws = (t >> 3) & 3, (t & 7) + 8 * (t >> 5)
            sw = ws & 7
            offs = (ws * 128 + (((4 * group + wj) ^ sw) << 4), ws * 128 + (((2 * wj) ^ sw) << 4),
                    ws * 128 + (((2 * wj + 1) ^ sw) << 4))
            for kind, off in zip(("in", "lo", "hi"), offs):
                chunks.setdefault((t // 8, kind), []).append((off >> 4) & 7)
            for h in (0, 32 * 128):
                in_off, lo_off, hi_off = (o + h for o in offs)
                words = box[in_off:in_off + 16].view("<u4")
                out = widen2_bits(np.stack([words, words >> 16], axis=1).reshape(-1))
                wide[lo_off:lo_off + 16] = out[:4].view(np.uint8)
                wide[hi_off:hi_off + 16] = out[4:].view(np.uint8)
                written[[lo_off // 16, hi_off // 16]] += 1
        assert (written == 1).all()
        assert all(len(set(c)) == 8 for c in chunks.values())
        s_b, r_b = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
        pos = swizzled(s_b, 2 * r_b)
        bits = wide[pos].astype(np.uint32) | (wide[pos + 1].astype(np.uint32) << 8)
        np.testing.assert_array_equal((bits << 16).view(np.float32),
                                      tile[:, 64 * group:64 * group + 64].astype(np.float32))


def a_fragment_offset(k, h, quad, pair, f32):
    """The kernel's ``a_off[k][h]``: the byte, from the fragment's row, of
    senders 16 k + pair (+ 8 h) of k-step k in a stage's frame; f32: box k /
    2 of 32 senders, bf16: one box of 64 senders; each chunk ^ quad."""
    if f32:
        return (k >> 1) * 64 * 128 + (((4 * (k & 1) + 2 * h + pair // 4) ^ quad) << 4) + 4 * (pair % 4)
    return (((2 * k + h) ^ quad) << 4) + 2 * pair


def test_a_fragment_reads_the_f32_frame_boxes():
    """A stage's float32 frame (64 features by 64 senders) in two 128-byte
    swizzled boxes of 32 senders: each thread's 64-bit loads at the kernel's
    offsets read its wgmma A fragment, features 16 warp + lane / 4 (+ 8),
    senders 16 k + 2 (lane % 4) (+ 1) and + 8, of each k-step k."""
    frame = np.random.default_rng(5).standard_normal((64, 64)).astype(np.float32)
    f_idx, s_idx = np.meshgrid(np.arange(64), np.arange(32), indexing="ij")
    boxes = np.zeros((2, 64 * 32), np.float32)
    for h in range(2):
        boxes[h, swizzled(f_idx, 4 * s_idx) // 4] = frame[:, 32 * h:32 * h + 32]
    stage = boxes.reshape(-1)
    for warp in range(4):
        for lane in range(32):
            quad, pair = lane // 4, 2 * (lane % 4)
            row = 16 * warp + quad
            for k in range(4):
                c0, c1 = (a_fragment_offset(k, h, quad, pair, f32=True) for h in range(2))
                got = [stage[(r * 128 + c) // 4:(r * 128 + c) // 4 + 2]
                       for r, c in ((row, c0), (row + 8, c0), (row, c1), (row + 8, c1))]
                want = [frame[r, 16 * k + pair + e:16 * k + pair + e + 2]
                        for r, e in ((row, 0), (row + 8, 0), (row, 8), (row + 8, 8))]
                np.testing.assert_array_equal(np.stack(got), np.stack(want))


def test_a_fragment_reads_the_bf16_frame_box():
    """B3c's and B3d's bfloat16 frame (64 features by 64 senders) in one
    128-byte swizzled box, as TMA writes either map's box: each thread's
    32-bit loads at the kernel's offsets read its wgmma A fragment, features
    16 warp + lane / 4 (+ 8), senders 16 k + 2 (lane % 4) (+ 1) and + 8,
    of each k-step k; each load of a warp meets every bank once."""
    frame = np.random.default_rng(6).integers(0, 1 << 16, (64, 64)).astype(np.uint16)
    f_idx, s_idx = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    box = np.zeros(64 * 64, np.uint16)
    box[swizzled(f_idx, 2 * s_idx) // 2] = frame
    for warp in range(4):
        banks = {}
        for lane in range(32):
            quad, pair = lane // 4, 2 * (lane % 4)
            row = 16 * warp + quad
            for k in range(4):
                c0, c1 = (a_fragment_offset(k, h, quad, pair, f32=False) for h in range(2))
                loads = ((row, c0), (row + 8, c0), (row, c1), (row + 8, c1))
                got = [box[(r * 128 + c) // 2:(r * 128 + c) // 2 + 2] for r, c in loads]
                want = [frame[r, 16 * k + pair + e:16 * k + pair + e + 2]
                        for r, e in ((row, 0), (row + 8, 0), (row, 8), (row + 8, 8))]
                np.testing.assert_array_equal(np.stack(got), np.stack(want))
                for j, (r, c) in enumerate(loads):
                    assert (r * 128 + c) % 4 == 0
                    banks.setdefault((k, j), []).append((r * 128 + c) // 4 % 32)
        assert all(sorted(b) == list(range(32)) for b in banks.values())


def k4_by_stages(q: tq.QuantizedBandedMatrixFM, xT: torch.Tensor, masked: bool) -> np.ndarray:
    """K4's kernel stage by stage in float64 numpy, on the operands its
    wrapper prepares: each 64-sender stage of a tile reads x through the
    2-D map (sender (rb + d - W)·x_block + s, zero fill outside [0,
    x_cols)) and the band's rows, zero fill at and past b'.  With ``masked``
    the k-steps at or past b' are set to zero, as the kernel now does.
    Products elementwise, so 0 · Inf is NaN as on the tensor cores."""
    nb, W, block, n = q.num_blocks, q.bandwidth, q.block, q.num_nodes
    band_p = band_mma.pad_band(q.band_qT).numpy().astype(np.float64)
    bp = band_p.shape[2]
    x, x_block, x_cols = band_mma.fm_x_operand(xT, n, nb, block)
    x = x.to(torch.bfloat16).to(torch.float64).numpy()
    scales = q.scales.numpy().astype(np.float64)
    out = np.zeros((xT.shape[0], nb, block))
    for rb in range(nb):
        acc = np.zeros((xT.shape[0], bp))
        for d in range(2 * W + 1):
            dot = np.zeros_like(acc)
            for kc in range(-(-bp // 64)):
                s = kc * 64 + np.arange(64)
                cols = (rb + d - W) * x_block + s
                inside = (cols >= 0) & (cols < x_cols)
                xs = np.where(inside, x[:, np.clip(cols, 0, x_cols - 1)], 0.0)
                if masked:
                    xs[:, kc * 64 + 16 * (np.arange(64) // 16) >= bp] = 0.0
                tile = np.zeros((64, bp))
                tile[s < bp] = band_p[rb, d, s[s < bp]]
                with np.errstate(invalid="ignore"):
                    dot += (xs[:, :, None] * tile[None]).sum(axis=1)
            with np.errstate(invalid="ignore"):
                acc += scales[rb, d] * dot
        out[:, rb] = acc[:, :block]
    return out.reshape(xT.shape[0], nb * block)[:, :n]


@pytest.mark.parametrize("block", [16, 48, 40])
def test_k4_stage_reads_past_its_node_block_only_without_the_mask(block):
    """An Inf in node block k: a 64-sender stage of a tile whose block is
    not a multiple of 64 reads on into the next node blocks' x (b = 16 and
    48 through xT itself, b = 40 through the padded copy, x_block = 48).
    Without the mask the Inf meets band rows of zero fill in row blocks
    that do not read block k, NaN where the plain version is finite; with
    it the stages give K4's plain version, NaN for NaN, and those row
    blocks stay finite."""
    nb, W, n, F = 10, 1, 10 * block - 7, 4
    q, scales, x = random_quantized((nb, W, block, n, F), seed=block)
    qf = tq.QuantizedBandedMatrixFM(torch.from_numpy(np.ascontiguousarray(np.swapaxes(q, 2, 3))),
                                    torch.from_numpy(scales), n, W)
    xT = torch.from_numpy(np.ascontiguousarray(x.T))
    k = nb // 2
    xT[1, k * block + 3] = float("inf")
    want = tq.banded_spmm_quant_fm_reference(qf, xT).numpy().reshape(F, -1)
    reads_k = np.abs(np.arange(nb * block)[:n] // block - k) <= W
    assert np.isfinite(want[:, ~reads_k]).all() and not np.isfinite(want[:, reads_k]).all()
    unmasked = k4_by_stages(qf, xT, masked=False)
    assert not np.isfinite(unmasked[:, ~reads_k]).all()
    masked = k4_by_stages(qf, xT, masked=True)
    assert np.isfinite(masked[:, ~reads_k]).all()
    np.testing.assert_allclose(masked, want, rtol=K3_RTOL, atol=K3_ATOL, equal_nan=True)


# ---------------------------------------------------------------------------
# K5: int8 x int8 on s8 products, role A's schedule over the transposed tiles
# ---------------------------------------------------------------------------

#: (num_blocks, W, block, num_nodes, F): a block of 100 (padded to 112), of
#: 16, W = 0, F = 1, 5 and 130 (three feature units), ragged tails, and the
#: main shape's block of 256 (two receiver tiles, two 128-sender stages)
K5_SHAPES = [(7, 1, 100, 650, 70), (12, 1, 16, 180, 8), (10, 0, 64, 600, 16), (10, 2, 64, 640, 1),
             (6, 1, 64, 350, 130), (10, 2, 64, 603, 5), (5, 2, 256, 1200, 64)]


def prmt(x, y, selector):
    """``__byte_perm(x, y, selector)``: byte n of the result is byte
    ``selector``'s nibble n of the eight bytes of ``x`` (0-3) and ``y``
    (4-7)."""
    both = [(int(x) >> (8 * i)) & 0xFF for i in range(4)] + [(int(y) >> (8 * i)) & 0xFF for i in range(4)]
    return sum(both[(int(selector) >> (4 * n)) & 7] << (8 * n) for n in range(4))


def k5_sender_offsets(group, warp, quad, t, rotate=True):
    """The kernel's ``s_off``: the byte, in a stage's swizzled tile box (128
    sender rows of 128 receiver bytes), of the i-th 16-bit load of a
    k-group, senders 4t + (i + t / 2) % 4 (rotated) and receivers 64 group +
    16 warp + 2 quad and + 1."""
    rot = t >> 1 if rotate else 0
    out = []
    for i in range(4):
        s = 4 * t + ((i + rot) & 3)
        out.append(s * 128 + (((4 * group + warp) ^ (s & 7)) << 4) + 2 * quad)
    return out, ((0x4206, 0x5317) if rot else (0x6420, 0x7531))


def k5_gather(box: np.ndarray, group: int, rotate=True):
    """Every thread of consumer warpgroup ``group`` gathers its s8 A
    fragments of a stage's four k32-steps as the kernel does; returns A
    [64 fragment rows' receivers, 128 senders] rebuilt from the fragment
    registers (receiver of row 16 warp + quad + 8 h: 16 warp + 2 quad + h),
    and for each load instruction of each warp the 32-bit words its lanes
    read."""
    A = np.full((64, 128), 999, np.int64)
    words = {}
    for warp in range(4):
        for lane in range(32):
            quad, t = lane // 4, lane % 4
            offs, (sel_lo, sel_hi) = k5_sender_offsets(group, warp, quad, t, rotate)
            for k in range(4):
                regs = []
                for h in range(2):
                    v = []
                    for i in range(4):
                        at = (32 * k + 16 * h) * 128 + offs[i]
                        v.append(int(box[at]) | (int(box[at + 1]) << 8))
                        words.setdefault((warp, k, h, i), []).append(at // 4)
                    x, y = prmt(v[0], v[1], 0x5410), prmt(v[2], v[3], 0x5410)
                    regs += [prmt(x, y, sel_lo), prmt(x, y, sel_hi)]
                # fragment register j: row q (even j) or q + 8, k 4t.. (j < 2) or 4t + 16..
                for j, reg in enumerate(regs):
                    r = 16 * warp + 2 * quad + (j & 1)
                    for e in range(4):
                        s = 32 * k + 16 * (j >> 1) + 4 * t + e
                        assert A[r, s] == 999
                        A[r, s] = np.int8(np.uint8((reg >> (8 * e)) & 0xFF))
    return A, words


def wavefronts(words) -> int:
    """Shared-memory wavefronts of one warp's load: the most distinct 32-bit
    words any bank is asked for (one word asked by several lanes is one)."""
    per_bank = {}
    for w in set(words):
        per_bank.setdefault(w % 32, set()).add(w)
    return max(len(v) for v in per_bank.values())


@pytest.mark.parametrize("seed", [0, 1])
def test_k5_fragment_gather_rebuilds_the_tile_and_meets_each_bank_once(seed):
    """A stage's transposed int8 tile (128 senders by 128 receivers, 128-byte
    swizzled as TMA writes it): each warpgroup's threads gather their s8 A
    fragments as the kernel does, 8 16-bit loads and 8 byte permutes a
    k32-step, and the fragments hold A[r, s] = tile[s, 64 group + r] for
    every receiver and sender, each once.  Every load of a warp is one
    wavefront; without the rotation of a thread's four senders, lanes t and
    t + 2 read the same chunk of rows four apart, two wavefronts a load."""
    tile = np.random.default_rng(seed).integers(-128, 128, (128, 128)).astype(np.int8)
    if seed == 1:
        tile[5, :] = np.arange(-128, 0)  # every negative byte
    s_idx, r_idx = np.meshgrid(np.arange(128), np.arange(128), indexing="ij")
    box = np.zeros(128 * 128, np.uint8)
    box[swizzled(s_idx, r_idx)] = tile.view(np.uint8)
    for group in range(2):
        A, words = k5_gather(box, group)
        np.testing.assert_array_equal(A, tile[:, 64 * group:64 * group + 64].T.astype(np.int64))
        assert len(words) == 4 * 4 * 8  # warps x k-steps x 8 loads
        assert all(wavefronts(w) == 1 for w in words.values())
        A, words = k5_gather(box, group, rotate=False)
        np.testing.assert_array_equal(A, tile[:, 64 * group:64 * group + 64].T.astype(np.int64))
        assert all(wavefronts(w) == 2 for w in words.values())


def test_k5_b_descriptor_reads_the_frame_box_k_major():
    """The int8 frame box (64 feature rows of 128 senders, swizzled): the
    K-major B descriptor of k32-step k starts 32 bytes on, and the core
    matrix of 8 feature rows by 16 bytes at (rows 8 g.., byte 16 c + 32 k)
    sits at the swizzled chunk (2 k + c) ^ (row % 8) of each row, where TMA
    put senders 32 k + 16 c .. + 15."""
    frame = np.random.default_rng(3).integers(-128, 128, (64, 128)).astype(np.int8)
    f_idx, s_idx = np.meshgrid(np.arange(64), np.arange(128), indexing="ij")
    box = np.zeros(64 * 128, np.uint8)
    box[swizzled(f_idx, s_idx)] = frame.view(np.uint8)
    for k in range(4):
        for g in range(8):
            for c in range(2):
                for row in range(8 * g, 8 * g + 8):
                    # the hardware's address: start + 1024 g (SBO) + 128 (row % 8) + 16 c, chunk bits ^ row % 8
                    linear = 32 * k + 1024 * g + 128 * (row % 8) + 16 * c
                    at = (linear & ~0x70) | ((((linear >> 4) & 7) ^ (row % 8)) << 4)
                    np.testing.assert_array_equal(box[at:at + 16].view(np.int8),
                                                  frame[row, 32 * k + 16 * c:32 * k + 16 * c + 16])


def test_k5_stores_fill_whole_sectors():
    """K5's sums leave the permuted fragment rows feature-major: a thread's
    two receivers side by side, one 8-byte store a feature.  Each store of a
    warp writes 16 receivers of 4 features, 256 bytes in whole 32-byte
    sectors, and the warpgroup's stores write each (receiver, feature) of
    its 64 x 64 once."""
    ldo, written = 1 << 20, {}
    for warp in range(4):
        for i in range(0, 32, 4):
            for e in range(2):
                lines = set()
                for lane in range(32):
                    quad, pair = lane // 4, 2 * (lane % 4)
                    r, f = 16 * warp + 2 * quad, 8 * (i >> 2) + pair + e
                    at = 4 * (f * ldo + r)
                    assert at % 8 == 0
                    lines.update(range(at, at + 8))
                    for h in range(2):
                        assert (r + h, f) not in written
                        written[r + h, f] = True
                sectors = {a // 32 for a in lines}
                assert len(lines) == 256 and len(sectors) * 32 == 256
    assert len(written) == 64 * 64


def test_k5_dot_is_exact_in_f32_at_the_saturated_bound():
    """Band and x all ±127 at b = 256 (every product 127² in magnitude, a
    tile of a single sign): each tile's dot, exact in int64 as in the
    kernel's s32, is at most 127²·256 < 2²⁴ and so equal to its float32
    conversion; the float32 plain version, whose float32 products and sums
    stay integers under 2²⁴, gives the kernel's order of roundings bit for
    bit, and K5's function on its operands equals it."""
    nb, W, b, n, F = 4, 1, 256, 4 * 256, 8
    rng = np.random.default_rng(7)
    band = (127 * rng.choice([-1, 1], (nb, 2 * W + 1, b, b))).astype(np.int8)
    band[1, 1] = 127  # one tile and one frame block of a single sign: the bound itself
    scales = rng.uniform(1e-3, 1.1e-2, (nb, 2 * W + 1)).astype(np.float32)
    q = tq.QuantizedBandedMatrixFM(torch.from_numpy(band), torch.from_numpy(scales), n, W)
    xT = torch.from_numpy(rng.choice([-1.0, 1.0], (F, n)).astype(np.float32))
    xT[:, b:2 * b] = 1.0  # frame block 2, which tile (1, 1) reads
    xq, xscales = tq.quantize_activations_padded(q, xT)
    assert int(xq[:, W * b:(W + nb) * b].abs().min()) == 127
    xw = xq.view(F, nb + 2 * W, b).permute(1, 0, 2).to(torch.int64)
    largest = 0
    for d in range(2 * W + 1):
        dots = torch.einsum("nfs,nsr->nfr", xw[d:d + nb], q.band_qT[:, d].to(torch.int64))
        largest = max(largest, int(dots.abs().max()))
        assert torch.equal(dots.to(torch.float32).to(torch.int64), dots)
        fdots = torch.bmm(xw[d:d + nb].to(torch.float32), q.band_qT[:, d].to(torch.float32))
        assert torch.equal(fdots.to(torch.int64), dots)
    assert largest == 127 * 127 * b < 2 ** 24
    want = tq.banded_spmm_quant_fm_w8a8_reference(q, xT)
    got = band_mma.w8a8_on_operands(q.band_qT, q.scales, xq, xscales, W, b)[:, :n]
    assert torch.equal(got, want)


def k5_operands(shape):
    """K5's operands as torch and JAX pairs: the feature-major int8 band and
    ``xT [F, n]``."""
    q, scales, x = random_quantized(shape, seed=sum(shape) + 5)
    nb, W, block, n, F = shape
    qT = np.ascontiguousarray(np.swapaxes(q, 2, 3))
    tqf = tq.QuantizedBandedMatrixFM(torch.from_numpy(qT), torch.from_numpy(scales), n, W)
    jqf = jq.QuantizedBandedMatrixFM(jnp.asarray(qT), jnp.asarray(scales), n, W)
    return tqf, jqf, np.ascontiguousarray(x.T)


def k5_on_operands(q: tq.QuantizedBandedMatrixFM, xT: torch.Tensor) -> torch.Tensor:
    """K5's kernel function on the operands its wrapper prepares: the padded
    band and the int8 frame padded by :func:`fm_frame` (itself where the
    block is a multiple of 16)."""
    nb, W, block, n = q.num_blocks, q.bandwidth, q.block, q.num_nodes
    xq, xscales = tq.quantize_activations_padded(q, xT)
    xq_p = band_mma.fm_frame(xq, nb, W, block)
    assert (xq_p is xq) == (block % 16 == 0) and xq_p.dtype == torch.int8
    return band_mma.w8a8_on_operands(band_mma.pad_band(q.band_qT), q.scales, xq_p, xscales, W, block)[:, :n]


@pytest.mark.parametrize("shape", K5_SHAPES, ids=shape_id)
def test_k5_on_its_operands_is_its_plain_version_bit_for_bit(shape):
    tqf, _, xT = k5_operands(shape)
    xt = torch.from_numpy(xT)
    got = k5_on_operands(tqf, xt)
    assert got.shape == (shape[4], shape[3])
    assert torch.equal(got, tq.banded_spmm_quant_fm_w8a8_reference(tqf, xt))


@pytest.mark.parametrize("shape", K5_SHAPES, ids=shape_id)
def test_k5_on_its_operands_matches_jax_interpret(shape):
    tqf, jqf, xT = k5_operands(shape)
    want = np.asarray(jq.banded_spmm_quant_fm_w8a8(jqf, jnp.asarray(xT), interpret=True))
    np.testing.assert_allclose(k5_on_operands(tqf, torch.from_numpy(xT)).numpy(), want,
                               rtol=K3_RTOL, atol=K3_ATOL)


# ---------------------------------------------------------------------------
# B2b: role A over the int8 band on K5's s8 products and int8 frame
# ---------------------------------------------------------------------------

#: B2b's blocks (16 and 48 unpadded, one partial 128-sender chunk; 40 padded
#: to 48), bandwidths and feature counts (one partial, one and three
#: 64-feature units)
B2B_BLOCKS, B2B_WS, B2B_FS = (16, 40, 48), (0, 1, 2), (1, 5, 130)


def b2b_fragments(box: np.ndarray, group: int):
    """Every thread of consumer warpgroup ``group`` loads its s8 A fragments
    of a stage's four k32-steps from the swizzled receiver-major box as the
    kernel does (``frag``, chunk (2k + h) ^ quad); returns A [64 rows, 128
    senders] rebuilt from the registers (register 2h of k-step k: row 16
    warp + quad, senders 32k + 16h + 4t .. + 3; register 2h + 1: the row 8
    on), and for each load instruction of each warp the 32-bit words its
    lanes read."""
    A = np.full((64, 128), 999, np.int64)
    words = {}
    for warp in range(4):
        for lane in range(32):
            quad, t = lane // 4, lane % 4
            frag = (64 * group + 16 * warp + quad) * 128 + 4 * t
            for k in range(4):
                for h in range(2):
                    c = frag + (((2 * k + h) ^ quad) << 4)
                    for j, at in enumerate((c, c + 8 * 128)):
                        assert at % 4 == 0
                        reg = int(box[at:at + 4].view("<u4")[0])
                        words.setdefault((warp, k, h, j), []).append(at // 4)
                        for e in range(4):
                            r, s = 16 * warp + quad + 8 * j, 32 * k + 16 * h + 4 * t + e
                            assert A[r, s] == 999
                            A[r, s] = np.int8(np.uint8((reg >> (8 * e)) & 0xFF))
    return A, words


@pytest.mark.parametrize("seed", [0, 1])
def test_b2b_fragment_loads_rebuild_the_tile_and_meet_each_bank_once(seed):
    """A stage's receiver-major int8 tile (128 receivers by 128 senders,
    128-byte swizzled as TMA writes it): each warpgroup's threads load their
    s8 A fragments as the kernel does, 4 32-bit loads a k32-step and no
    permute, and the fragments hold A[r, s] = tile[64 group + r, s] for
    every receiver and sender, each once: receiver 16 warp + lane / 4 (and
    + 8), senders 32k + 16h + 4 (lane % 4) .. + 3.  Every load of a warp
    reads 32 distinct words, one in each bank: one wavefront."""
    tile = np.random.default_rng(seed).integers(-128, 128, (128, 128)).astype(np.int8)
    if seed == 1:
        tile[9, :] = np.arange(-128, 0)  # every negative byte
    r_idx, s_idx = np.meshgrid(np.arange(128), np.arange(128), indexing="ij")
    box = np.zeros(128 * 128, np.uint8)
    box[swizzled(r_idx, s_idx)] = tile.view(np.uint8)
    for group in range(2):
        A, words = b2b_fragments(box, group)
        np.testing.assert_array_equal(A, tile[64 * group:64 * group + 64].astype(np.int64))
        assert len(words) == 4 * 4 * 2 * 2  # warps x k-steps x k-groups x rows
        for w in words.values():
            assert wavefronts(w) == 1 and sorted(a % 32 for a in w) == list(range(32))


@pytest.mark.parametrize("F", B2B_FS)
@pytest.mark.parametrize("W", B2B_WS)
@pytest.mark.parametrize("block", B2B_BLOCKS)
def test_b2b_on_its_operands_is_its_plain_version_bit_for_bit(block, W, F):
    """B2b's function on the operands its wrapper prepares (the band padded
    by :func:`pad_band`, x quantized node-major and transposed into K5's
    frame by :func:`w8a8_fm_frame`, padded to b') equals its plain version
    on the original operands bit for bit, with a ragged tail."""
    nb = 5
    n = nb * block - 7
    q, scales, x = random_quantized((nb, W, block, n, F), seed=block + 10 * W + F)
    tqq = tq.QuantizedBandedMatrix(torch.from_numpy(q), torch.from_numpy(scales), n, W)
    xt = torch.from_numpy(x)
    xq_p, xscales = tv.w8a8_operands(tqq, xt)
    bp = band_mma.padded(block, 16)
    assert xq_p.dtype == torch.int8 and xq_p.shape == (F, (nb + 2 * W) * bp) and xq_p.is_contiguous()
    assert xscales.shape == (nb + 2 * W,)
    band_p = band_mma.pad_band(tqq.band_q)
    assert (band_p is tqq.band_q) == (bp == block)
    got = band_mma.rowmajor_w8a8_on_operands(band_p, tqq.scales, xq_p, xscales, n, W, block)
    assert got.shape == (n, F)
    assert torch.equal(got, tv.banded_spmm_w8a8_reference(tqq, xt))


def test_b2b_dot_is_exact_at_the_saturated_bound():
    """Band and x all ±127 at b = 256, one tile all +127 against a frame
    block all +127 (a dot of 127²·256 < 2²⁴): B2b's function on its
    operands equals the plain version bit for bit."""
    nb, W, b, F = 4, 1, 256, 8
    n = nb * b - 5
    rng = np.random.default_rng(9)
    band = (127 * rng.choice([-1, 1], (nb, 2 * W + 1, b, b))).astype(np.int8)
    band[1, 1] = 127
    scales = rng.uniform(1e-3, 1.1e-2, (nb, 2 * W + 1)).astype(np.float32)
    q = tq.QuantizedBandedMatrix(torch.from_numpy(band), torch.from_numpy(scales), n, W)
    x = torch.from_numpy(rng.choice([-1.0, 1.0], (n, F)).astype(np.float32))
    x[b:2 * b] = 1.0  # frame block 2, which tile (1, 1) reads
    xq_p, xscales = tv.w8a8_operands(q, x)
    assert int(xq_p[:, W * b:(W + nb) * b - 5].abs().min()) == 127
    got = band_mma.rowmajor_w8a8_on_operands(q.band_q, q.scales, xq_p, xscales, n, W, b)
    assert torch.equal(got, tv.banded_spmm_w8a8_reference(q, x))


def test_k5_left_the_cuda_core_body():
    """K5's and B2b's C entry points are in ``csrc/band_mma.cu`` on s8
    products, and so is the dma-only probe's (``Variant::kDmaOnly``, role
    B's ring); ``csrc/banded_spmm.cu`` and ``csrc/fm_pipeline.cu`` are gone,
    and the band body keeps no int8 CUDA-core dot and no ``cp.async`` ring."""
    import os

    csrc = os.path.join(os.path.dirname(band_mma.__file__), "..", "csrc")
    mma = open(os.path.join(csrc, "band_mma.cu")).read()
    assert "int cgt_banded_spmm_quant_fm_w8a8(" in mma and "m64n64k32.s32.s8.s8" in mma
    assert "int cgt_banded_spmm_w8a8_rowmajor(" in mma
    assert "int cgt_fm_dma_only(" in mma and "Variant::kDmaOnly" in mma
    for gone in ("banded_spmm.cu", "fm_pipeline.cu"):
        assert not os.path.exists(os.path.join(csrc, gone))
    assert not [name for name in os.listdir(csrc) if "__dp4a" in open(os.path.join(csrc, name)).read()]
    for gone in ("cp.async.cg", "cp.async.wait_group", "fm_pipeline_kernel"):
        assert gone not in mma


# ---------------------------------------------------------------------------
# B3a dma-only: role B's ring, a copy-plus-add consumer
# ---------------------------------------------------------------------------

#: (num_blocks, W, block, num_nodes, F) for B3a dma-only: blocks of 16, 40
#: (padded to 48) and 48, whose one partial stage carries every receiver
#: and feature, and 80 (a partial second stage), each at W = 0, 1, 2 and F =
#: 1, 5 and the block, ragged tails; and F = 130 at a block of 160, three
#: feature units, so band rows f >= 64 come from sender chunks ft >= 1
DMA_ONLY_SHAPES = [(5, W, b, 5 * b - 3 - W, F) for b in (16, 40, 48, 80) for W in (0, 1, 2)
                   for F in (1, 5, b)] + [(4, 1, 160, 610, 130)]


def dma_only_operands(shape):
    """B3a dma-only's operands: the feature-major int8 band, ``xT [F, n]``,
    and what its wrapper hands the launch, the padded band and the padded
    bfloat16 frame."""
    q, scales, x = random_quantized(shape, seed=sum(shape) + 15)
    nb, W, block, n, F = shape
    qf = tq.QuantizedBandedMatrixFM(torch.from_numpy(np.ascontiguousarray(np.swapaxes(q, 2, 3))),
                                    torch.from_numpy(scales), n, W)
    xT = torch.from_numpy(np.ascontiguousarray(x.T))
    frame_p = band_mma.fm_frame(fv.pad_xT(xT, n, nb, W, block), nb, W, block)
    assert (frame_p.shape[1] // (nb + 2 * W)) % 16 == 0
    return qf, xT, band_mma.pad_band(qf.band_qT), frame_p


@pytest.mark.parametrize("shape", DMA_ONLY_SHAPES, ids=shape_id)
def test_dma_only_on_its_operands_is_its_plain_version_bit_for_bit(shape):
    nb, W, block, n, F = shape
    qf, xT, band_p, frame_p = dma_only_operands(shape)
    got = band_mma.dma_only_on_operands(band_p, frame_p, n, W, block, F)
    assert got.shape == (F, n)
    assert torch.equal(got, fv.fm_dma_only_reference(qf, xT, rows_per_step=1))


def dma_only_by_stages(band_p: np.ndarray, frame_p: np.ndarray, nb: int, W: int, block: int, n: int,
                       F: int):
    """B3a dma-only's kernel in numpy, unit by unit, on the padded band and
    the padded frame's bfloat16 bits: the boxes of each stage
    of diagonal 0 as TMA writes them (128-byte rows, swizzled, zero fill
    past b' and F), then every thread's loads at the kernel's offsets into
    role B's accumulator layout, entry 4j + 2h + e feature 16 warp + quad +
    8h by receiver 8j + pair + e: x from the frame box of sender chunk 2 mt
    + group, the band from the band box of sender chunk ft; float32 adds from
    0, stores masked to b, n and F.  Returns (out [F, n] float32, the
    (unit, group, stage) reads, the most wavefronts any warp load takes)."""
    bp = band_p.shape[2]
    nk, mtiles, ftiles = -(-bp // 64), -(-bp // 128), -(-F // 64)
    x_bits = frame_p.view(np.uint16).reshape(F, nb + 2 * W, bp)

    def band_box(rb, kc, mt):  # sender rows 64 kc.., 128 receivers 128 mt.. of tile (rb, 0)
        box = np.zeros(64 * 128, np.uint8)
        s, r = np.meshgrid(np.arange(64), np.arange(128), indexing="ij")
        ok = (64 * kc + s < bp) & (128 * mt + r < bp)
        box[swizzled(s[ok], r[ok])] = band_p[rb, 0][64 * kc + s[ok], 128 * mt + r[ok]].view(np.uint8)
        return box

    def frame_box(rb, kc, ft):  # feature rows 64 ft.., 64 senders 64 kc.. of frame block rb
        box = np.zeros(64 * 64, np.uint16)
        f, s = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
        ok = (64 * ft + f < F) & (64 * kc + s < bp)
        box[swizzled(f[ok], 2 * s[ok]) // 2] = x_bits[64 * ft + f[ok], rb, 64 * kc + s[ok]]
        return box.view(np.uint8)

    warp, lane, j, h = np.meshgrid(np.arange(4), np.arange(32), np.arange(8), np.arange(2), indexing="ij")
    quad, pair = lane // 4, 2 * (lane % 4)
    row = (16 * warp + quad + 8 * h) * 128
    out, reads, waves = np.zeros((F, n), np.float32), set(), 0
    for u in range(nb * mtiles * ftiles):
        ft, mt, rb = u % ftiles, (u // ftiles) % mtiles, u // (ftiles * mtiles)
        for group in range(2):
            acc = np.zeros((4, 32, 8, 2, 2), np.float32)  # [warp, lane, j, h, e]
            for kc in range(nk):  # diagonal 0; the other diagonals' stages are released untouched
                if kc == 2 * mt + group:
                    reads.add((u, group, ("x", kc)))
                    off = row + ((j ^ quad) << 4) + 2 * pair
                    words = frame_box(rb, kc, ft).view("<u4")[off // 4]
                    acc += np.stack([(words << 16).view(np.float32),
                                     (words & 0xFFFF0000).view(np.float32)], axis=-1)
                    waves = max(waves, max(wavefronts(list(off[w, :, jj, hh] // 4))
                                           for w in range(4) for jj in range(8) for hh in range(2)))
                if kc == ft:
                    reads.add((u, group, ("band", kc)))
                    off = row + (((4 * group + (j >> 1)) ^ quad) << 4) + 8 * (j & 1) + pair
                    box = band_box(rb, kc, mt).view(np.int8)
                    acc += np.stack([box[off], box[off + 1]], axis=-1).astype(np.float32)
                    waves = max(waves, max(wavefronts(list(off[w, :, jj, hh] // 4))
                                           for w in range(4) for jj in range(8) for hh in range(2)))
            f = 64 * ft + np.broadcast_to((16 * warp + quad + 8 * h)[..., None], acc.shape)
            r = 128 * mt + 64 * group + np.broadcast_to((8 * j + pair)[..., None] + np.arange(2), acc.shape)
            node = rb * block + r
            ok = (f < F) & (r < block) & (node < n)
            out[f[ok], node[ok]] = acc[ok]
    return out, reads, waves


@pytest.mark.parametrize("shape", [(5, 0, 16, 77, 16), (5, 2, 40, 197, 5), (4, 1, 80, 317, 80),
                                   (4, 1, 160, 610, 130), (2, 2, 256, 500, 64)], ids=shape_id)
def test_dma_only_consumer_reads_rebuild_the_output(shape):
    """The consumer's loads from the swizzled boxes of role B's stages, at
    the kernel's offsets, rebuild B3a dma-only's output bit for bit its
    plain version; each warpgroup reads two stages a unit (x from sender
    chunk 2 mt + group where that chunk exists, the band from chunk ft), and
    each load of a warp meets every bank once."""
    nb, W, block, n, F = shape
    qf, xT, band_p, frame_p = dma_only_operands(shape)
    got, reads, waves = dma_only_by_stages(band_p.numpy(), frame_p.view(torch.int16).numpy(), nb, W, block,
                                           n, F)
    assert torch.equal(torch.from_numpy(got), fv.fm_dma_only_reference(qf, xT, rows_per_step=1))
    assert waves == 1
    bp, ftiles = band_p.shape[2], -(-F // 64)
    nk, mtiles = -(-bp // 64), -(-bp // 128)
    for u in range(nb * mtiles * ftiles):
        ft, mt = u % ftiles, (u // ftiles) % mtiles
        for group in range(2):
            want = {(u, group, ("band", ft))} | ({(u, group, ("x", 2 * mt + group))} if 2 * mt + group < nk
                                                 else set())
            assert {r for r in reads if r[:2] == (u, group)} == want
