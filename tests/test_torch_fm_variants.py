"""The port's feature-major band-pipeline probes B3a-B3d
(``ops/fm_variants.py``) against the kernel functions of
``benchmarks/fm_kernel_diag.py``, on the same inputs made with numpy.

The JAX side runs its Pallas kernels on the CPU with ``interpret=True``.
``pad_xT``, ``quantize_xT_blocks`` and ``fm_dma_only`` (a float32 add of a
bfloat16 and an int8 value) are bitwise equal; the others match at rtol
1e-5 / atol 1e-5 (the same exact products, float32 sums in another order).
The inputs: a spatial graph and random NON-symmetric int8 bands at block
64, where a swapped tile axis would show, covering W = 0, F = 1, F = 5, a
ragged tail, and NB in {8, 12} with R in {2, 4}, so that
``fm_compute_only``'s chunk i* (the largest even chunk) is 0, 2 and 4.
``fm_deep`` and ``fm_blocked`` agree with one port result at several
(R, S, K).  Their kernels are role B of ``csrc/band_mma.cu`` over the int8
band: ``fm_deep`` K4's launch on ``xT``, ``fm_blocked`` on its bfloat16
blocked frame.  Role B's function on the operands the wrappers prepare
(the padded band, ``xT`` as K4's map reads it, which equals role B on
``fm_frame(pad_xT(xT))`` bit for bit, and the blocked frame) is their
plain versions bit for bit and JAX's in interpret mode at 1e-5, at block
64 and at blocks of 16 and 48.  ``fm_w8a8`` is K5's launch on its given
operands: K5's function on them (the padded band and the int8 frame padded
by ``fm_frame``) is its plain version bit for bit and JAX's at 1e-5, at
those blocks and at a block of 40, which the wrapper pads to 48.  The
kernels themselves run only on the card
(``tests/test_torch_fm_variants_cuda.py``); ``fm_dma_only``'s on its
prepared operands, and a numpy emulation of its consumer's reads from role
B's swizzled stages, are in ``tests/test_torch_band_mma.py``.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import connectome_gnn_tpu.data as jd
import connectome_gnn_tpu.ops.banded as jb
import connectome_gnn_tpu.ops.banded_quant as jq
import connectome_gnn_tpu_torch.data as td
import connectome_gnn_tpu_torch.ops.banded as tb
import connectome_gnn_tpu_torch.ops.banded_quant as tq
import connectome_gnn_tpu_torch.ops.fm_variants as fv
from connectome_gnn_tpu_torch.ops import band_mma

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import benchmarks.fm_kernel_diag as fd  # noqa: E402

RTOL, ATOL = 1e-5, 1e-5
#: the checks' gate against the float32 band SpMM (the script's rel_err,
#: held as benchmarks/quant_kernel_diag.py:327 holds it)
CHECK_GATE = 3e-2
#: case → (num_blocks, W, num_nodes, F, R) of a random band at block 64, or
#: None for a spatial graph (1280 nodes, block 64 so NB = 20 and W = 1,
#: F = 16, R = 4)
CASES = {
    "spatial-1280": None,
    "nonsymmetric-nb8-R4": (8, 1, 512, 16, 4),
    "nonsymmetric-W0-nb12-R2": (12, 0, 768, 16, 2),
    "nonsymmetric-F5-ragged-nb12-R4": (12, 2, 700, 5, 4),
    "nonsymmetric-F1-ragged-nb8-R2": (8, 1, 500, 1, 2),
}
BLOCK = 64


class Case:
    """One case's operands in both packages, checked bitwise equal where
    they are built apart."""

    def __init__(self, ja, ta, xT, R):
        self.R, self.xT = R, xT
        self.jq = jq.to_feature_major(jq.quantize_band(ja))
        self.tq = tq.to_feature_major(tq.quantize_band(ta))
        np.testing.assert_array_equal(self.tq.band_qT.numpy(), np.asarray(self.jq.band_qT))
        np.testing.assert_array_equal(self.tq.scales.numpy(), np.asarray(self.jq.scales))
        # the script's bf16 band: the int8 kernel's scale structure, bf16 payload
        inv = 1.0 / torch.clamp_min(self.tq.scales, 1e-30)
        self.band_bf16T = (ta.band * inv[:, :, None, None]).to(torch.bfloat16).transpose(2, 3).contiguous()
        self.n, self.W, self.nb = ta.num_nodes, ta.bandwidth, self.tq.num_blocks


def spatial_band(n, block, F, seed):
    """The same spatial graph's float32 band in both packages (bitwise)."""
    kw = dict(degree=6, band=40, num_features=F, seed=seed)
    jg, tg = jd.generate_spatial_graph(n, **kw), td.generate_spatial_graph(n, **kw)
    ja = jb.to_banded(jg.edge_index[0], jg.edge_index[1], jg.edge_weight, n, block=block)
    ta = tb.to_banded(tg.edge_index[0], tg.edge_index[1], tg.edge_weight, n, block=block)
    np.testing.assert_array_equal(ta.band.numpy(), np.asarray(ja.band))
    return ja, ta, np.ascontiguousarray(tg.node_features.T)


@pytest.fixture(scope="module")
def cases():
    out = {}
    for name, spec in CASES.items():
        if spec is None:
            ja, ta, xT = spatial_band(1280, BLOCK, 16, seed=3)
            out[name] = Case(ja, ta, xT, 4)
            continue
        nb, W, n, F, R = spec
        rng = np.random.default_rng(n + F + W)
        shape = (nb, 2 * W + 1, BLOCK, BLOCK)
        band = (rng.standard_normal(shape) * (rng.random(shape) < 0.3)).astype(np.float32)
        band[0, 0] = 0
        xT = rng.standard_normal((F, n)).astype(np.float32)
        out[name] = Case(jb.BandedMatrix(jnp.asarray(band), n, W),
                         tb.BandedMatrix(torch.from_numpy(band), n, W), xT, R)
    return out


def jax_padded(c, dtype=jnp.bfloat16):
    return fd._pad_xT(jnp.asarray(c.xT), c.n, c.nb, c.W, BLOCK, dtype)


def port_padded(c, dtype=torch.bfloat16):
    return fv.pad_xT(torch.from_numpy(c.xT), c.n, c.nb, c.W, BLOCK, dtype)


def as_f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("case", list(CASES))
def test_pad_xT_and_quantize_xT_blocks_are_bitwise_equal(cases, case):
    c = cases[case]
    tpad = port_padded(c)
    assert tpad.dtype == torch.bfloat16 and tpad.shape == (c.xT.shape[0], (c.nb + 2 * c.W) * BLOCK)
    np.testing.assert_array_equal(tpad.float().numpy(), as_f32(jax_padded(c)))
    jxq, jxs = fd.quantize_xT_blocks(jax_padded(c), BLOCK)
    txq, txs = fv.quantize_xT_blocks(tpad, BLOCK)
    assert txq.dtype == torch.int8 and txs.shape == (c.nb + 2 * c.W,)
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(txs.numpy(), np.asarray(jxs))


@pytest.mark.parametrize("case", list(CASES))
def test_fm_dma_only_is_bitwise_equal(cases, case):
    c = cases[case]
    got = fv.fm_dma_only(c.tq, torch.from_numpy(c.xT), rows_per_step=c.R)
    want = np.asarray(fd.fm_dma_only(c.jq, jnp.asarray(c.xT), rows_per_step=c.R, interpret=True))
    assert got.dtype == torch.float32 and got.shape == want.shape == c.xT.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", list(CASES))
def test_fm_compute_only_matches_jax(cases, case):
    """Chunk i*'s panel; i* is 0, 2 or 4 across the cases."""
    c = cases[case]
    got = fv.fm_compute_only(c.tq, torch.from_numpy(c.xT), rows_per_step=c.R)
    want = np.asarray(fd.fm_compute_only(c.jq, jnp.asarray(c.xT), rows_per_step=c.R, interpret=True))
    assert got.shape == want.shape == (c.xT.shape[0], c.R * BLOCK)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["nonsymmetric-W0-nb12-R2", "nonsymmetric-F5-ragged-nb12-R4"])
def test_fm_compute_only_reads_panel_0_and_chunk_i_stars_scales(cases, case):
    """Band rows past R and activations past window 0 do not matter; the
    scales of chunk i* (4 at NB = 12, R = 2; 2 at R = 4) do."""
    c = cases[case]
    q, xT, R = c.tq, torch.from_numpy(c.xT), c.R
    got = fv.fm_compute_only(q, xT, rows_per_step=R)
    band, x = q.band_qT.clone(), xT.clone()
    band[R:] = 0
    x[:, (R + c.W) * BLOCK :] = 0
    assert torch.equal(fv.fm_compute_only(q._replace(band_qT=band), x, rows_per_step=R), got)
    i_star = (c.nb // R - 1) // 2 * 2
    assert i_star > 0
    scales = q.scales.clone()
    scales[i_star * R : (i_star + 1) * R] *= 2
    torch.testing.assert_close(fv.fm_compute_only(q._replace(scales=scales), xT, rows_per_step=R),
                               2 * got, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", list(CASES))
def test_fm_bf16_band_matches_jax(cases, case):
    c = cases[case]
    got = fv.fm_bf16_band(c.band_bf16T, c.tq.scales, c.n, c.W, torch.from_numpy(c.xT), rows_per_step=c.R)
    jband = jnp.asarray(c.band_bf16T.float().numpy()).astype(jnp.bfloat16)
    want = np.asarray(fd.fm_bf16_band(jband, c.jq.scales, c.n, c.W, jnp.asarray(c.xT),
                                      rows_per_step=c.R, interpret=True))
    assert got.shape == want.shape == c.xT.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", list(CASES))
def test_fm_w8a8_matches_jax_on_the_given_operands(cases, case):
    c = cases[case]
    txq, txs = fv.quantize_xT_blocks(port_padded(c), BLOCK)
    jxq, jxs = fd.quantize_xT_blocks(jax_padded(c), BLOCK)
    got = fv.fm_w8a8(c.tq, txq, txs, rows_per_step=c.R)
    want = np.asarray(fd.fm_w8a8(c.jq, jxq, jxs, rows_per_step=c.R, interpret=True))
    assert got.shape == want.shape == c.xT.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", list(CASES))
def test_fm_w8a8_is_k5_on_float32_padded_operands(cases, case):
    """K5 quantizes the float32-padded frame; on those operands fm_w8a8 is
    K5's function bit for bit (so K5's kernel is a second oracle)."""
    c = cases[case]
    q, xT = c.tq, torch.from_numpy(c.xT)
    got = fv.fm_w8a8(q, *fv.quantize_xT_blocks(port_padded(c, torch.float32), BLOCK), rows_per_step=c.R)
    assert torch.equal(got, tq.banded_spmm_quant_fm_w8a8_reference(q, xT))


@pytest.mark.parametrize("case", list(CASES))
def test_fm_deep_and_fm_blocked_match_jax(cases, case):
    c = cases[case]
    xT = torch.from_numpy(c.xT)
    got = fv.fm_deep(c.tq, xT, rows_per_step=c.R)
    want = np.asarray(fd.fm_deep(c.jq, jnp.asarray(c.xT), rows_per_step=c.R, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert torch.equal(got, tq.banded_spmm_quant_fm_reference(c.tq, xT))
    txb = tq.to_blocked(port_padded(c), BLOCK)
    jxb = fd.to_blocked(jax_padded(c), BLOCK)
    np.testing.assert_array_equal(txb.float().numpy(), as_f32(jxb))
    got_b = fv.fm_blocked(c.tq, txb, rows_per_step=c.R)
    want_b = np.asarray(fd.fm_blocked(c.jq, jxb, rows_per_step=c.R, interpret=True))
    assert got_b.shape == want_b.shape == (c.nb, c.xT.shape[0], BLOCK)
    np.testing.assert_allclose(got_b.numpy(), want_b, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tq.from_blocked(got_b)[:, : c.n].numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("R,S,K", [(2, 2, 1), (4, 3, 2), (4, 4, 4), (8, 6, 2), (12, 8, 1), (5, 3, 1)])
def test_fm_deep_at_each_depth_and_split_matches_one_port_result(cases, R, S, K):
    """JAX at (R, S, K) against the one port result (NB = 12: R = 8 runs as
    6, R = 5 as 4)."""
    c = cases["nonsymmetric-F5-ragged-nb12-R4"]
    got = fv.fm_deep(c.tq, torch.from_numpy(c.xT), rows_per_step=R, depth=S, band_splits=K)
    want = np.asarray(fd.fm_deep(c.jq, jnp.asarray(c.xT), rows_per_step=R, depth=S, band_splits=K,
                                 interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("R,S", [(2, 2), (4, 4), (8, 6), (3, 8)])
def test_fm_blocked_at_each_depth_matches_one_port_result(cases, R, S):
    c = cases["nonsymmetric-F5-ragged-nb12-R4"]
    got = fv.fm_blocked(c.tq, tq.to_blocked(port_padded(c), BLOCK), rows_per_step=R, depth=S)
    want = np.asarray(fd.fm_blocked(c.jq, fd.to_blocked(jax_padded(c), BLOCK), rows_per_step=R,
                                    depth=S, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


#: case → (num_blocks, W, block, num_nodes, F) of a random int8 band beside
#: CASES: blocks of 16 and 48, multiples of 16 but not of 64, so that a
#: 64-sender stage of role B reaches past the block (zero fill in the 3-D
#: frame maps), W = 0, 1, 2, F = 5, ragged tails
ROLE_B_SHAPES = {"b16-W1": (12, 1, 16, 180, 8), "b48-W2-F5-ragged": (10, 2, 48, 470, 5),
                 "b48-W0": (8, 0, 48, 380, 16)}
ROLE_B_CASES = list(CASES) + list(ROLE_B_SHAPES)
#: fm_w8a8's further shape on K5's launch: a block of 40, not a multiple of
#: 16, which its wrapper pads to 48
W8A8_SHAPES = {"b40-W1-F5-ragged": (6, 1, 40, 230, 5)}
W8A8_CASES = ROLE_B_CASES + list(W8A8_SHAPES)


def role_b_case(cases, case):
    """(port band, JAX band, xT numpy [F, n], block) of a case of CASES at
    block 64, or of a random non-symmetric int8 band of ROLE_B_SHAPES."""
    if case in CASES:
        c = cases[case]
        return c.tq, c.jq, c.xT, BLOCK
    nb, W, block, n, F = {**ROLE_B_SHAPES, **W8A8_SHAPES}[case]
    rng = np.random.default_rng(nb + block + n)
    shape = (nb, 2 * W + 1, block, block)
    qT = (rng.integers(-127, 128, shape) * (rng.random(shape) < 0.3)).astype(np.int8)
    scales = rng.uniform(1e-3, 1.1e-2, shape[:2]).astype(np.float32)
    xT = rng.standard_normal((F, n)).astype(np.float32)
    return (tq.QuantizedBandedMatrixFM(torch.from_numpy(qT), torch.from_numpy(scales), n, W),
            jq.QuantizedBandedMatrixFM(jnp.asarray(qT), jnp.asarray(scales), n, W), xT, block)


def deep_on_operands(q, xT: torch.Tensor, block: int) -> torch.Tensor:
    """B3c's kernel function on the operands its wrapper prepares, K4's:
    the padded int8 band and ``xT`` as K4's 2-D map reads it, rounded to
    bfloat16 as the kernel rounds it; checked bit for bit against role B
    on the bfloat16 frame ``fm_frame(pad_xT(xT))``, the route it was
    timed against."""
    nb, W, n = q.num_blocks, q.bandwidth, q.num_nodes
    band_p = band_mma.pad_band(q.band_qT)
    x, x_block, x_cols = band_mma.fm_x_operand(xT, n, nb, block)
    frame = band_mma.fm_window_frame(x, x_block, x_cols, nb, W, band_p.shape[2])
    got = band_mma.fm_on_operands(band_p, q.scales, frame, W, block)[:, :n]
    bf16_frame = band_mma.fm_frame(fv.pad_xT(xT, n, nb, W, block), nb, W, block)
    assert torch.equal(got, band_mma.fm_on_operands(band_p, q.scales, bf16_frame, W, block)[:, :n])
    return got


def blocked_on_operands(q, xb: torch.Tensor, block: int) -> torch.Tensor:
    """B3d's kernel function on the operands its wrapper prepares: the
    padded int8 band and the caller's bfloat16 blocked frame."""
    xb_p = band_mma.blocked_x_operand(xb, block)
    return band_mma.blocked_on_operands(band_mma.pad_band(q.band_qT), q.scales, xb_p, q.bandwidth, block)


def blocked_frames(q, xT: np.ndarray, block: int):
    """The bfloat16 blocked frame ``[NB + 2W, F, block]`` in both packages."""
    n, nb, W = q.num_nodes, q.num_blocks, q.bandwidth
    txb = tq.to_blocked(fv.pad_xT(torch.from_numpy(xT), n, nb, W, block), block)
    jxb = fd.to_blocked(fd._pad_xT(jnp.asarray(xT), n, nb, W, block, jnp.bfloat16), block)
    return txb, jxb


@pytest.mark.parametrize("case", ROLE_B_CASES)
def test_fm_deep_on_its_role_b_operands_is_its_plain_version_bit_for_bit(cases, case):
    q, _, xT, block = role_b_case(cases, case)
    xt = torch.from_numpy(xT)
    assert torch.equal(deep_on_operands(q, xt, block), fv.fm_deep_reference(q, xt))


@pytest.mark.parametrize("case", ROLE_B_CASES)
def test_fm_deep_on_its_role_b_operands_matches_jax_interpret(cases, case):
    q, jqf, xT, block = role_b_case(cases, case)
    want = np.asarray(fd.fm_deep(jqf, jnp.asarray(xT), rows_per_step=4, interpret=True))
    np.testing.assert_allclose(deep_on_operands(q, torch.from_numpy(xT), block).numpy(), want,
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ROLE_B_CASES)
def test_fm_blocked_on_its_role_b_operands_is_its_plain_version_bit_for_bit(cases, case):
    q, _, xT, block = role_b_case(cases, case)
    txb, _ = blocked_frames(q, xT, block)
    got = blocked_on_operands(q, txb, block)
    assert got.shape == (q.num_blocks, xT.shape[0], block)
    assert torch.equal(got, fv.fm_blocked_reference(q, txb))


@pytest.mark.parametrize("case", ROLE_B_CASES)
def test_fm_blocked_on_its_role_b_operands_matches_jax_interpret(cases, case):
    q, jqf, xT, block = role_b_case(cases, case)
    txb, jxb = blocked_frames(q, xT, block)
    np.testing.assert_array_equal(txb.float().numpy(), as_f32(jxb))
    want = np.asarray(fd.fm_blocked(jqf, jxb, rows_per_step=4, interpret=True))
    np.testing.assert_allclose(blocked_on_operands(q, txb, block).numpy(), want, rtol=RTOL, atol=ATOL)


def w8a8_frames(q, xT: np.ndarray, block: int):
    """``fm_w8a8``'s given operands, the bfloat16 padded frame quantized per
    block, in both packages (checked bitwise equal): ``(port (xq, xs), JAX
    (xq, xs))``."""
    n, nb, W = q.num_nodes, q.num_blocks, q.bandwidth
    txq, txs = fv.quantize_xT_blocks(fv.pad_xT(torch.from_numpy(xT), n, nb, W, block), block)
    jxq, jxs = fd.quantize_xT_blocks(fd._pad_xT(jnp.asarray(xT), n, nb, W, block, jnp.bfloat16), block)
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(txs.numpy(), np.asarray(jxs))
    return (txq, txs), (jxq, jxs)


def w8a8_on_operands(q, xq: torch.Tensor, xs: torch.Tensor, block: int) -> torch.Tensor:
    """``fm_w8a8``'s kernel function on the operands its wrapper hands K5's
    launch: the padded int8 band and the int8 frame padded by
    :func:`~connectome_gnn_tpu_torch.ops.band_mma.fm_frame` (itself where the
    block is a multiple of 16)."""
    nb, W = q.num_blocks, q.bandwidth
    xq_p = band_mma.fm_frame(xq, nb, W, block)
    assert (xq_p is xq) == (block % 16 == 0)
    out = band_mma.w8a8_on_operands(band_mma.pad_band(q.band_qT), q.scales, xq_p, xs, W, block)
    return out[:, : q.num_nodes]


@pytest.mark.parametrize("case", W8A8_CASES)
def test_fm_w8a8_on_k5s_operands_is_its_plain_version_bit_for_bit(cases, case):
    q, _, xT, block = role_b_case(cases, case)
    (xq, xs), _ = w8a8_frames(q, xT, block)
    got = w8a8_on_operands(q, xq, xs, block)
    assert got.shape == (xT.shape[0], q.num_nodes)
    assert torch.equal(got, fv.fm_w8a8_reference(q, xq, xs, rows_per_step=2))


@pytest.mark.parametrize("case", W8A8_CASES)
def test_fm_w8a8_on_k5s_operands_matches_jax_interpret(cases, case):
    q, jqf, xT, block = role_b_case(cases, case)
    (xq, xs), (jxq, jxs) = w8a8_frames(q, xT, block)
    want = np.asarray(fd.fm_w8a8(jqf, jxq, jxs, rows_per_step=2, interpret=True))
    np.testing.assert_allclose(w8a8_on_operands(q, xq, xs, block).numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("variant", ["fm_deep", "fm_blocked", "fm_bf16_band", "fm_w8a8"])
def test_checks_phase_at_a_small_size(cases, variant):
    """Each variant within 3e-2 relative Frobenius error of the float32
    band SpMM, in both packages."""
    c = cases["spatial-1280"]
    ja, ta, xT = spatial_band(1280, BLOCK, 16, seed=3)
    xt = torch.from_numpy(xT)
    if variant == "fm_deep":
        tout = fv.fm_deep(c.tq, xt)
        jout = fd.fm_deep(c.jq, jnp.asarray(xT), rows_per_step=4, interpret=True)
    elif variant == "fm_blocked":
        tout = tq.from_blocked(fv.fm_blocked(c.tq, tq.to_blocked(port_padded(c), BLOCK)))[:, : c.n]
        jb_out = fd.fm_blocked(c.jq, fd.to_blocked(jax_padded(c), BLOCK), rows_per_step=4, interpret=True)
        jout = jnp.swapaxes(jb_out, 0, 1).reshape(xT.shape[0], -1)[:, : c.n]
    elif variant == "fm_bf16_band":
        tout = fv.fm_bf16_band(c.band_bf16T, c.tq.scales, c.n, c.W, xt, rows_per_step=4)
        jband = jnp.asarray(c.band_bf16T.float().numpy()).astype(jnp.bfloat16)
        jout = fd.fm_bf16_band(jband, c.jq.scales, c.n, c.W, jnp.asarray(xT), rows_per_step=4,
                               interpret=True)
    else:
        tout = fv.fm_w8a8(c.tq, *fv.quantize_xT_blocks(port_padded(c), BLOCK), rows_per_step=4)
        jout = fd.fm_w8a8(c.jq, *fd.quantize_xT_blocks(jax_padded(c), BLOCK), rows_per_step=4,
                          interpret=True)
    tref = tb.banded_spmm(ta, xt.T.contiguous()).T
    jref = np.asarray(jb.banded_spmm(ja, jnp.asarray(xT.T))).T
    terr = float(torch.linalg.norm(tout - tref) / torch.linalg.norm(tref))
    jerr = np.linalg.norm(np.asarray(jout) - jref) / np.linalg.norm(jref)
    assert 0 < terr < CHECK_GATE and 0 < jerr < CHECK_GATE
    np.testing.assert_allclose(terr, jerr, rtol=1e-3)


def _bad_calls(c):
    """name → a call that JAX leaves undefined or asserts on (NB = 12)."""
    q, xT = c.tq, torch.from_numpy(c.xT)
    xq, xs = fv.quantize_xT_blocks(port_padded(c), BLOCK)
    wide = torch.zeros((BLOCK + 1, c.n))
    return {
        "dma_only nb % R": (lambda: fv.fm_dma_only(q, xT, rows_per_step=5), "whole chunks"),
        "compute_only nb % R": (lambda: fv.fm_compute_only(q, xT, rows_per_step=5), "whole chunks"),
        "bf16_band nb % R": (lambda: fv.fm_bf16_band(c.band_bf16T, q.scales, c.n, c.W, xT, 8), "whole chunks"),
        "w8a8 nb % R": (lambda: fv.fm_w8a8(q, xq, xs, rows_per_step=8), "whole chunks"),
        "dma_only F > block": (lambda: fv.fm_dma_only(q, wide, rows_per_step=4), "exceeds the block"),
        "deep R % K": (lambda: fv.fm_deep(q, xT, rows_per_step=6, band_splits=4), "does not divide"),
        "deep depth": (lambda: fv.fm_deep(q, xT, depth=5), "depth 5"),
        "deep split": (lambda: fv.fm_deep(q, xT, rows_per_step=3, band_splits=3), "not one of"),
        "blocked depth": (lambda: fv.fm_blocked(q, tq.to_blocked(port_padded(c), BLOCK), depth=1), "depth 1"),
        "bf16_band f32 band": (lambda: fv.fm_bf16_band(c.band_bf16T.float(), q.scales, c.n, c.W, xT, 4),
                               "bfloat16"),
    }


@pytest.mark.parametrize("name", [
    "dma_only nb % R", "compute_only nb % R", "bf16_band nb % R", "w8a8 nb % R", "dma_only F > block",
    "deep R % K", "deep depth", "deep split", "blocked depth", "bf16_band f32 band"])
def test_undefined_geometries_raise(cases, name):
    fn, match = _bad_calls(cases["nonsymmetric-F5-ragged-nb12-R4"])[name]
    with pytest.raises(ValueError, match=match):
        fn()


def test_entry_points_take_the_plain_version_on_cpu(cases):
    c = cases["nonsymmetric-nb8-R4"]
    q, xT = c.tq, torch.from_numpy(c.xT)
    kernels = [fv.fm_dma_only_kernel, fv.fm_compute_only_kernel, fv.fm_bf16_band_kernel,
               fv.fm_w8a8_kernel, fv.fm_deep_kernel, fv.fm_blocked_kernel]
    before = [k.launches for k in kernels]
    xq, xs = fv.quantize_xT_blocks(port_padded(c), BLOCK)
    xb = tq.to_blocked(port_padded(c), BLOCK)
    pairs = [
        (fv.fm_dma_only(q, xT, 4), fv.fm_dma_only_reference(q, xT, 4)),
        (fv.fm_compute_only(q, xT, 4), fv.fm_compute_only_reference(q, xT, 4)),
        (fv.fm_bf16_band(c.band_bf16T, q.scales, c.n, c.W, xT, 4),
         fv.fm_bf16_band_reference(c.band_bf16T, q.scales, c.n, c.W, xT, 4)),
        (fv.fm_w8a8(q, xq, xs, 4), fv.fm_w8a8_reference(q, xq, xs, 4)),
        (fv.fm_deep(q, xT, 4, 3, 2), fv.fm_deep_reference(q, xT, 4, 3, 2)),
        (fv.fm_blocked(q, xb, 4, 4), fv.fm_blocked_reference(q, xb, 4, 4)),
    ]
    for got, want in pairs:
        assert torch.equal(got, want)
    assert [k.launches for k in kernels] == before


@pytest.mark.parametrize("kernel", ["dma_only", "compute_only", "bf16_band", "w8a8", "deep", "blocked"])
def test_kernel_wrappers_refuse_cpu_tensors(cases, kernel):
    c = cases["nonsymmetric-nb8-R4"]
    q, xT = c.tq, torch.from_numpy(c.xT)
    fn, args = {
        "dma_only": (fv.fm_dma_only_kernel, (q, xT, 4)),
        "compute_only": (fv.fm_compute_only_kernel, (q, xT, 4)),
        "bf16_band": (fv.fm_bf16_band_kernel, (c.band_bf16T, q.scales, c.n, c.W, xT, 4)),
        "w8a8": (fv.fm_w8a8_kernel, (q, *fv.quantize_xT_blocks(port_padded(c), BLOCK), 4)),
        "deep": (fv.fm_deep_kernel, (q, xT)),
        "blocked": (fv.fm_blocked_kernel, (q, tq.to_blocked(port_padded(c), BLOCK))),
    }[kernel]
    before = fn.launches
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fn(*args)
    assert fn.launches == before


def test_fm_deep_and_fm_blocked_left_the_cuda_core_pipeline():
    """B3c and B3d launch role B of ``csrc/band_mma.cu`` (B3c through K4's
    entry, B3d through its own bfloat16-frame entry), and so does B3a
    dma-only (``Variant::kDmaOnly`` on role B's ring); ``fm_pipeline.cu``,
    the probes' two-stage ring, is gone, and none of its depth S, band
    splits or ring remains."""
    csrc = os.path.join(os.path.dirname(fv.__file__), "..", "csrc")
    mma = open(os.path.join(csrc, "band_mma.cu")).read()
    for entry in ("cgt_banded_spmm_quant_fm", "cgt_banded_spmm_quant_fm_bf16",
                  "cgt_banded_spmm_quant_blocked_bf16", "cgt_fm_dma_only"):
        assert f"int {entry}(" in mma
    assert not os.path.exists(os.path.join(csrc, "fm_pipeline.cu"))
    for gone in ("cgt_fm_deep", "cgt_fm_blocked", "launch_int8_depth", "band_splits", "int S>",
                 "fm_pipeline_kernel", "cp.async.cg", "int cgt_fm_w8a8("):
        assert gone not in mma
    assert "Variant::kDmaOnly" in mma and "int cgt_fm_compute_only(" in mma


def test_fm_compute_only_left_the_cuda_core_pipeline():
    """B3b launches role B of ``csrc/band_mma.cu`` with its panel map, and
    B3a dma-only with its copy-plus-add consumer; ``fm_pipeline.cu`` is
    gone, so no CUDA-core probe body remains."""
    csrc = os.path.join(os.path.dirname(fv.__file__), "..", "csrc")
    mma = open(os.path.join(csrc, "band_mma.cu")).read()
    assert "int cgt_fm_compute_only(" in mma and "Variant::kPanel" in mma
    assert "int cgt_fm_dma_only(" in mma and "Variant::kDmaOnly" in mma
    assert not os.path.exists(os.path.join(csrc, "fm_pipeline.cu"))
    for gone in ("kComputeOnly", "kDots", "__dp4a"):
        assert gone not in mma


#: R of each role B case for B3b: NB = 12 at R = 4 puts chunk i* at 2, NB =
#: 10 and 8 at R = 2 at 4 and 2
PANEL_R = {"b16-W1": 4, "b48-W2-F5-ragged": 2, "b48-W0": 2}


def panel_by_units(q, xT: torch.Tensor, block: int, R: int):
    """B3b's kernel, unit by unit in numpy, on the operands its wrapper
    prepares (panel 0 of the band and window 0 of the bfloat16 frame, padded
    to b'): every (row block rb = i·R + r, 128-receiver tile, 64-feature
    tile) unit of role B reads band row rr = (r + i) mod R, frame block kk =
    (r + d + i) mod (R + 2W) and scale row rb; each tile's dot exact (float64,
    as the tensor cores' products of int8 and bfloat16 are), then added in
    float32 times its scale.  Chunk i*'s units store at column r·b + c; the
    others add their sums into the sink.  Returns (panel [F, R·b], sink,
    the band rows and frame blocks read)."""
    nb, W, n = q.num_blocks, q.bandwidth, q.num_nodes
    D = 2 * W + 1
    panel = band_mma.pad_band(q.band_qT[:R]).numpy().astype(np.float64)
    bp, F = panel.shape[2], xT.shape[0]
    x_win = fv._pad_fm(xT[:, : min(n, (R + W) * block)], R, W, block, torch.bfloat16)
    frame = band_mma.fm_frame(x_win, R, W, block).float().numpy().astype(np.float64)
    scales = q.scales.numpy()
    mtiles, ftiles = -(-bp // 128), -(-F // 64)
    i_star = (nb // R - 1) // 2 * 2
    out, sink, rows, blocks = np.zeros((F, R * block), np.float32), np.float32(0), set(), set()
    for u in range(nb * mtiles * ftiles):
        ft, mt, rb = u % ftiles, (u // ftiles) % mtiles, u // (ftiles * mtiles)
        chunk, r = divmod(rb, R)
        rr = (r + chunk) % R
        f0, r0 = 64 * ft, 128 * mt
        acc = np.zeros((min(64, F - f0), 128), np.float32)
        for d in range(D):
            kk = (r + d + chunk) % (R + 2 * W)
            rows.add(rr)
            blocks.add(kk)
            tile = np.zeros((bp, 128))
            tile[:, : min(128, bp - r0)] = panel[rr, d][:, r0:r0 + 128]
            dot = (frame[f0:f0 + 64, kk * bp:(kk + 1) * bp] @ tile).astype(np.float32)
            acc += np.float32(scales[rb, d]) * dot
        cols = min(128, block - r0)
        if cols <= 0:
            continue
        if chunk == i_star:
            out[f0:f0 + 64, r * block + r0:r * block + r0 + cols] = acc[:, :cols]
        else:
            sink += acc.sum(dtype=np.float32)
    return out, sink, rows, blocks


def panel_case(cases, case):
    """(port band, JAX band, xT numpy [F, n], block, R) of a CASES case or a
    role B shape."""
    if case in CASES:
        c = cases[case]
        return c.tq, c.jq, c.xT, BLOCK, c.R
    q, jqf, xT, block = role_b_case(cases, case)
    return q, jqf, xT, block, PANEL_R[case]


@pytest.mark.parametrize("case", list(CASES) + list(PANEL_R))
def test_fm_compute_only_panel_map_over_role_b_units_is_its_plain_version(cases, case):
    """The emulated units reproduce ``fm_compute_only_reference`` (1e-5:
    float32 sums in another order), read only band rows 0..R-1 and frame
    blocks 0..R+2W-1, all of them, and fold every other chunk into a finite
    sink."""
    q, _, xT, block, R = panel_case(cases, case)
    xt = torch.from_numpy(xT)
    got, sink, rows, blocks = panel_by_units(q, xt, block, R)
    assert rows == set(range(R)) and blocks == set(range(R + 2 * q.bandwidth))
    assert np.isfinite(sink) and (q.num_blocks // R > 1) == (sink != 0)
    np.testing.assert_allclose(got, fv.fm_compute_only_reference(q, xt, rows_per_step=R).numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", list(CASES) + list(PANEL_R))
def test_fm_compute_only_panel_map_over_role_b_units_matches_jax_interpret(cases, case):
    q, jqf, xT, block, R = panel_case(cases, case)
    want = np.asarray(fd.fm_compute_only(jqf, jnp.asarray(xT), rows_per_step=R, interpret=True))
    got, _, _, _ = panel_by_units(q, torch.from_numpy(xT), block, R)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
