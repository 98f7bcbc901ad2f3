"""The port's K7 (``ops/banded_direct.py``) and band variants B2a-B2c
(``ops/band_variants.py``) against the JAX functions, on the same inputs
made with numpy.

The JAX side runs its Pallas kernels on the CPU: K7 with
``interpret=True``, the B2 kernels of ``benchmarks/quant_kernel_diag.py``
(which take no ``interpret`` argument) under
``pltpu.force_tpu_interpret_mode()``.  The port's plain versions match
them at rtol 1e-5 / atol 1e-5 (the same exact products, float32 sums in
another order), on a spatial graph and on random NON-symmetric bands,
where a swapped tile axis would show: with the ragged tail, W = 0, F = 5
and F = 1.  ``quantize_x_blocks`` is bitwise equal, and so is the int8
frame B2b's wrapper hands its kernel: the node-major quantization
transposed to K5's feature-major frame and padded to a block that is a
multiple of 16, against JAX's ``quantize_x_blocks`` transposed.  B2b's
function on those operands is JAX's kernel in interpret mode at 1e-5.  The JAX kernels'
``rows_per_step`` changes only the order of a float32 sum, so one port
result matches all of them.  The checks phase of the script, at a small
size: each variant within 3e-2 relative Frobenius error of the float32
band SpMM, in both packages.  The kernels themselves run only on the card
(``tests/test_torch_band_variants_cuda.py``).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import connectome_gnn_tpu.data as jd
import connectome_gnn_tpu.ops.banded as jb
import connectome_gnn_tpu.ops.banded_quant as jq
import connectome_gnn_tpu_torch.data as td
import connectome_gnn_tpu_torch.ops.band_mma as band_mma
import connectome_gnn_tpu_torch.ops.band_variants as tv
import connectome_gnn_tpu_torch.ops.banded as tb
import connectome_gnn_tpu_torch.ops.banded_direct as tdir
import connectome_gnn_tpu_torch.ops.banded_quant as tq
from connectome_gnn_tpu.ops.banded_pallas import banded_spmm_pallas

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import benchmarks.quant_kernel_diag as qd  # noqa: E402

RTOL, ATOL = 1e-5, 1e-5
#: the checks phase's gate, benchmarks/quant_kernel_diag.py:327
CHECK_GATE = 3e-2
VARIANTS = ["B2a", "B2b", "B2c", "B2c-wrow-bf16"]
#: case → (num_blocks, W, num_nodes, F) of a random band at block 64; None
#: for the spatial graph of tests/test_banded.py's Pallas test (700 nodes,
#: block 32, F = 16)
CASES = {
    "spatial-700": None,
    "nonsymmetric-ragged-600": (10, 1, 600, 16),
    "nonsymmetric-W0": (10, 0, 600, 16),
    "nonsymmetric-F5": (10, 2, 640, 5),
    "nonsymmetric-F1": (10, 1, 600, 1),
}


def spatial_band(n, block, F, seed):
    """The same spatial graph's float32 band in both packages (bitwise)."""
    kw = dict(degree=6, band=40, num_features=F, seed=seed)
    jg, tg = jd.generate_spatial_graph(n, **kw), td.generate_spatial_graph(n, **kw)
    ja = jb.to_banded(jg.edge_index[0], jg.edge_index[1], jg.edge_weight, n, block=block)
    ta = tb.to_banded(tg.edge_index[0], tg.edge_index[1], tg.edge_weight, n, block=block)
    np.testing.assert_array_equal(ta.band.numpy(), np.asarray(ja.band))
    return ja, ta, tg.node_features


def random_case(nb, W, n, F, seed):
    """A random non-symmetric float32 band (70 % zeros, tile (0, 0) all
    zero) and activations, as numpy."""
    rng = np.random.default_rng(seed)
    shape = (nb, 2 * W + 1, 64, 64)
    band = (rng.standard_normal(shape) * (rng.random(shape) < 0.3)).astype(np.float32)
    band[0, 0] = 0
    return band, rng.standard_normal((n, F)).astype(np.float32)


@pytest.fixture(scope="module")
def operands():
    """case → JAX and port float32 bands, their int8 quantizations
    (bitwise equal), and x."""
    out = {}
    for case, spec in CASES.items():
        if spec is None:
            ja, ta, x = spatial_band(700, 32, 16, seed=3)
        else:
            nb, W, n, F = spec
            band, x = random_case(nb, W, n, F, seed=n + F + W)
            ja = jb.BandedMatrix(jnp.asarray(band), n, W)
            ta = tb.BandedMatrix(torch.from_numpy(band), n, W)
        jqq, tqq = jq.quantize_band(ja), tq.quantize_band(ta)
        np.testing.assert_array_equal(tqq.band_q.numpy(), np.asarray(jqq.band_q))
        out[case] = (ja, ta, jqq, tqq, x)
    return out


def bf16_band(ja, ta):
    """Both packages' bfloat16 band (round to nearest even), checked equal."""
    jband, tband = ja.band.astype(jnp.bfloat16), ta.band.to(torch.bfloat16)
    np.testing.assert_array_equal(tband.to(torch.float32).numpy(),
                                  np.asarray(jband.astype(jnp.float32)))
    return jband, tband


def jax_variant(variant, ja, jqq, x, rows_per_step=8):
    """A B2 kernel of benchmarks/quant_kernel_diag.py, interpreted on the CPU."""
    xj = jnp.asarray(x)
    with pltpu.force_tpu_interpret_mode():
        if variant == "B2a":
            return np.asarray(qd.banded_spmm_bf16_pallas(
                ja.band.astype(jnp.bfloat16), ja.num_nodes, ja.bandwidth, xj, rows_per_step))
        if variant == "B2b":
            return np.asarray(qd.banded_spmm_w8a8(jqq, xj, rows_per_step))
        return np.asarray(qd.banded_spmm_quant_fused_dot(
            jqq, xj, rows_per_step, wrow_bf16=variant == "B2c-wrow-bf16"))


def port_variant(variant, ta, tqq, x, entry=True):
    """The port's B2 entry point (or its plain version), on CPU tensors."""
    xt = torch.from_numpy(x)
    if variant == "B2a":
        fn = tv.banded_spmm_bf16 if entry else tv.banded_spmm_bf16_reference
        return fn(ta.band.to(torch.bfloat16), ta.num_nodes, ta.bandwidth, xt)
    if variant == "B2b":
        return (tv.banded_spmm_w8a8 if entry else tv.banded_spmm_w8a8_reference)(tqq, xt)
    fn = tv.banded_spmm_quant_fused_dot if entry else tv.banded_spmm_quant_fused_dot_reference
    return fn(tqq, xt, wrow_bf16=variant == "B2c-wrow-bf16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_k7_plain_version_matches_jax_interpret(operands, case, dtype):
    ja, ta, _, _, x = operands[case]
    if dtype == "bfloat16":
        jband, tband = bf16_band(ja, ta)
        ja, ta = ja._replace(band=jband), ta._replace(band=tband)
    got = tdir.banded_spmm_direct_reference(ta, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == x.shape
    want = np.asarray(banded_spmm_pallas(ja, jnp.asarray(x), interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_k7_bf16_rounds_x_where_banded_spmm_does_not(operands):
    """The trap: ``banded_spmm`` widens a bf16 band but keeps x float32; K7
    rounds x to bf16 first."""
    _, ta, _, _, x = operands["spatial-700"]
    a16 = ta._replace(band=ta.band.to(torch.bfloat16))
    xt = torch.from_numpy(x)
    got = tdir.banded_spmm_direct_reference(a16, xt)
    torch.testing.assert_close(got, tb.banded_spmm(a16, xt.to(torch.bfloat16).float()),
                               rtol=RTOL, atol=ATOL)
    assert not torch.allclose(got, tb.banded_spmm(a16, xt), rtol=RTOL, atol=ATOL)


def test_k7_refuses_other_band_dtypes(operands):
    _, ta, _, tqq, x = operands["nonsymmetric-W0"]
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tdir.banded_spmm_direct(ta._replace(band=ta.band.double()), torch.from_numpy(x))
    with pytest.raises(ValueError, match="bfloat16"):
        tv.banded_spmm_bf16(ta.band, ta.num_nodes, ta.bandwidth, torch.from_numpy(x))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("case", list(CASES))
def test_b2_plain_versions_match_jax_interpret(operands, case, variant):
    ja, ta, jqq, tqq, x = operands[case]
    got = port_variant(variant, ta, tqq, x, entry=False)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), jax_variant(variant, ja, jqq, x), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("rows_per_step", [1, 2, 8])
@pytest.mark.parametrize("variant", VARIANTS)
def test_rows_per_step_changes_only_the_sum_order(operands, variant, rows_per_step):
    """JAX's panel size R against the one port result (at 10 row blocks the
    JAX kernels take R = 1, 2 and 5)."""
    ja, ta, jqq, tqq, x = operands["nonsymmetric-ragged-600"]
    got = port_variant(variant, ta, tqq, x)
    want = jax_variant(variant, ja, jqq, x, rows_per_step)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("blocks", [6, 13])
def test_quantize_x_blocks_is_bitwise_equal(blocks):
    rng = np.random.default_rng(blocks)
    x = np.zeros((blocks, 64, 7), np.float32)  # the outer blocks stay zero: scale 1
    x[1:-1] = rng.standard_normal((blocks - 2, 64, 7)) * rng.uniform(0.1, 10, (blocks - 2, 1, 1))
    x[2, 5, 3] = 1e-30  # a block of near-zero values
    jxq, jxs = qd.quantize_x_blocks(jnp.asarray(x))
    txq, txs = tv.quantize_x_blocks(torch.from_numpy(x))
    assert txq.dtype == torch.int8 and txs.dtype == torch.float32 and txs.shape == (blocks,)
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(txs.numpy(), np.asarray(jxs))
    assert txs[0] == txs[-1] == 1.0


def b2b_case(block, W, F, seed):
    """A random non-symmetric int8 band in both packages (70 % zeros) with a
    ragged tail, and x, at ``block``."""
    nb = 5
    n = nb * block - 3
    rng = np.random.default_rng(seed)
    shape = (nb, 2 * W + 1, block, block)
    band = (rng.standard_normal(shape) * (rng.random(shape) < 0.3)).astype(np.float32)
    x = rng.standard_normal((n, F)).astype(np.float32)
    x[: block // 2] *= 40.0  # one block's scale far from the others'
    jqq = jq.quantize_band(jb.BandedMatrix(jnp.asarray(band), n, W))
    tqq = tq.quantize_band(tb.BandedMatrix(torch.from_numpy(band), n, W))
    return jqq, tqq, x


@pytest.mark.parametrize("F", [1, 5, 130])
@pytest.mark.parametrize("block", [16, 40, 48])
def test_b2b_frame_is_jax_quantize_x_blocks_transposed(block, F):
    """B2b's int8 frame and scales (:func:`w8a8_operands`) bitwise against
    JAX's ``quantize_x_blocks`` of the padded frame, transposed to ``[F,
    (NB + 2W)·b']`` with zeros past each block's ``b`` senders."""
    W = 2
    _, tqq, x = b2b_case(block, W, F, seed=block + F)
    xq_p, xs = tv.w8a8_operands(tqq, torch.from_numpy(x))
    nb, n = tqq.num_blocks, tqq.num_nodes
    x_pad = np.zeros(((nb + 2 * W) * block, F), np.float32)
    x_pad[W * block : W * block + n] = x
    jxq, jxs = qd.quantize_x_blocks(jnp.asarray(x_pad).reshape(nb + 2 * W, block, F))
    bp = band_mma.padded(block, 16)
    want = np.zeros((F, nb + 2 * W, bp), np.int8)
    want[:, :, :block] = np.asarray(jxq).transpose(2, 0, 1)
    assert xq_p.dtype == torch.int8 and xq_p.is_contiguous()
    np.testing.assert_array_equal(xq_p.numpy(), want.reshape(F, -1))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))


@pytest.mark.parametrize("W", [0, 1, 2])
@pytest.mark.parametrize("block", [16, 40, 48])
def test_b2b_on_its_operands_matches_jax_interpret(block, W):
    """B2b's function on the operands its wrapper prepares against JAX's
    ``banded_spmm_w8a8`` in interpret mode."""
    F = 5
    jqq, tqq, x = b2b_case(block, W, F, seed=block + W)
    xq_p, xs = tv.w8a8_operands(tqq, torch.from_numpy(x))
    got = band_mma.rowmajor_w8a8_on_operands(band_mma.pad_band(tqq.band_q), tqq.scales, xq_p, xs,
                                             tqq.num_nodes, W, block)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(qd.banded_spmm_w8a8(jqq, jnp.asarray(x), 5))
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("variant", VARIANTS + ["manual"])
def test_checks_phase_at_a_small_size(variant):
    """``quant_kernel_diag.py``'s checks phase: each variant against the
    float32 band SpMM, relative Frobenius error under 3e-2, in both
    packages."""
    ja, ta, x = spatial_band(1280, 64, 64, seed=5)
    xt = torch.from_numpy(x)
    jqq, tqq = jq.quantize_band(ja), tq.quantize_band(ta)
    if variant == "manual":
        with pltpu.force_tpu_interpret_mode():
            jout = np.asarray(qd.banded_spmm_quant_manual(jqq, jnp.asarray(x)))
        tout = tv.banded_spmm_quant_manual(tqq, xt)
        # K4's plain version on the transposed operand: the same function
        np.testing.assert_allclose(tout.numpy(), jout, rtol=RTOL, atol=ATOL)
    else:
        jout, tout = jax_variant(variant, ja, jqq, x), port_variant(variant, ta, tqq, x)
    jref = np.asarray(jb.banded_spmm(ja, jnp.asarray(x)))
    tref = tb.banded_spmm(ta, xt)
    jerr = np.linalg.norm(jout - jref) / np.linalg.norm(jref)
    terr = float(torch.linalg.norm(tout - tref) / torch.linalg.norm(tref))
    assert 0 < terr < CHECK_GATE and 0 < jerr < CHECK_GATE
    np.testing.assert_allclose(terr, jerr, rtol=1e-3)


def test_entry_points_take_the_plain_version_on_cpu(operands):
    ja, ta, _, tqq, x = operands["nonsymmetric-F5"]
    kernels = [tdir.banded_spmm_direct_kernel, tv.banded_spmm_bf16_kernel, tv.banded_spmm_w8a8_kernel,
               tv.banded_spmm_quant_fused_dot_kernel]
    before = [k.launches for k in kernels]
    xt = torch.from_numpy(x)
    assert torch.equal(tdir.banded_spmm_direct(ta, xt), tdir.banded_spmm_direct_reference(ta, xt))
    for variant in VARIANTS:
        assert torch.equal(port_variant(variant, ta, tqq, x),
                           port_variant(variant, ta, tqq, x, entry=False))
    assert [k.launches for k in kernels] == before


@pytest.mark.parametrize("kernel", ["K7", "B2a", "B2b", "B2c"])
def test_kernel_wrappers_refuse_cpu_tensors(operands, kernel):
    _, ta, _, tqq, x = operands["nonsymmetric-ragged-600"]
    xt = torch.from_numpy(x)
    fn, args = {
        "K7": (tdir.banded_spmm_direct_kernel, (ta, xt)),
        "B2a": (tv.banded_spmm_bf16_kernel, (ta.band.to(torch.bfloat16), 600, 1, xt)),
        "B2b": (tv.banded_spmm_w8a8_kernel, (tqq, xt)),
        "B2c": (tv.banded_spmm_quant_fused_dot_kernel, (tqq, xt)),
    }[kernel]
    before = fn.launches
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fn(*args)
    assert fn.launches == before


def test_w8a8_plain_version_refuses_blocks_past_its_exactness_bound():
    q = tq.QuantizedBandedMatrix(torch.zeros((1, 1, 1041, 1041), dtype=torch.int8),
                                 torch.ones((1, 1)), 1041, 0)
    with pytest.raises(ValueError, match="no longer exact"):
        tv.banded_spmm_w8a8_reference(q, torch.zeros((1041, 2)))
