"""The port's int8 band ops and the plain versions of K3, K4 and K5 against
the JAX package, whose Pallas kernels run with ``interpret=True``.

Quantization and layouts are bitwise equal.  The plain K3, K4 and K5 match
JAX's kernels at rtol 1e-5 / atol 1e-5 (JAX's own kernel-versus-emulation
gate: the same exact products, float32 sums in another order) on a
spatial graph and on random NON-symmetric bands, where a swapped tile axis
would show: with the ragged tail (600 nodes), with W = 0, and with SAGE's
first-layer width F = 5.  The kernels themselves run only on the card
(``tests/test_torch_banded_cuda.py``).
"""

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

RTOL, ATOL = 1e-5, 1e-5


def random_band(nb, W, block, seed):
    """Random non-symmetric int8 tiles (70 % zeros, tile (0, 0) all zero
    with scale 1) and per-tile scales, as numpy."""
    rng = np.random.default_rng(seed)
    shape = (nb, 2 * W + 1, block, block)
    q = (rng.integers(-127, 128, shape) * (rng.random(shape) < 0.3)).astype(np.int8)
    scales = rng.uniform(1e-3, 1.1e-2, shape[:2]).astype(np.float32)
    q[0, 0], scales[0, 0] = 0, 1.0
    return q, scales


def spatial(n, seed=0, **kw):
    jg = jd.generate_spatial_graph(n, degree=6, band=40, num_features=16, seed=seed, **kw)
    tg = td.generate_spatial_graph(n, degree=6, band=40, num_features=16, seed=seed, **kw)
    return jg, tg


def coo(g):
    return g.edge_index[0], g.edge_index[1], g.edge_weight


#: case → (nb, W, num_nodes, F) for a random band; None for the spatial graph
CASES = {
    "spatial-640": None,
    "nonsymmetric-ragged-600": (10, 1, 600, 16),
    "nonsymmetric-W0": (10, 0, 600, 16),
    "nonsymmetric-F5": (10, 2, 640, 5),
}


@pytest.fixture(scope="module")
def operands():
    """case → (JAX QuantizedBandedMatrix, port QuantizedBandedMatrix, x)."""
    out = {}
    for case, spec in CASES.items():
        if spec is None:
            jg, tg = spatial(640)
            jqq = jq.quantize_band(jb.to_banded(*coo(jg), 640, block=64))
            tqq = tq.quantize_band(tb.to_banded(*coo(tg), 640, block=64))
            x = tg.node_features
        else:
            nb, W, n, F = spec
            q, s = random_band(nb, W, 64, seed=n + F + W)
            jqq = jq.QuantizedBandedMatrix(jnp.asarray(q), jnp.asarray(s), n, W)
            tqq = tq.QuantizedBandedMatrix(torch.from_numpy(q), torch.from_numpy(s), n, W)
            x = np.random.default_rng(n).standard_normal((n, F)).astype(np.float32)
        out[case] = (jqq, tqq, x)
    return out


@pytest.mark.parametrize("n", [640, 600])
def test_quantize_band_is_bitwise_equal(n):
    jg, tg = spatial(n)
    ja, ta = jb.to_banded(*coo(jg), n, block=64), tb.to_banded(*coo(tg), n, block=64)
    # the raw band (SAGE's operand) and JAX's normalized one (GCN's), the
    # same float32 values on both sides
    jn = jb.gcn_normalize_banded(ja)[0]
    tn = tb.BandedMatrix(torch.from_numpy(np.array(jn.band)), n, jn.bandwidth)
    for jband, tband in ((ja, ta), (jn, tn)):
        jqq, tqq = jq.quantize_band(jband), tq.quantize_band(tband)
        assert tqq.band_q.dtype == torch.int8 and tqq.scales.dtype == torch.float32
        np.testing.assert_array_equal(tqq.band_q.numpy(), np.asarray(jqq.band_q))
        np.testing.assert_array_equal(tqq.scales.numpy(), np.asarray(jqq.scales))
        assert (tqq.num_nodes, tqq.bandwidth, tqq.block, tqq.num_blocks) == (
            jqq.num_nodes, jqq.bandwidth, jqq.block, jqq.num_blocks)


def test_zero_tiles_get_scale_one_and_the_error_bound_holds():
    _, tg = spatial(640)
    a = tb.to_banded(*coo(tg), 640, block=64)
    q = tq.quantize_band(a)
    zero = ~a.band.ne(0).any(dim=3).any(dim=2)
    assert bool(zero.any())
    assert bool((q.scales[zero] == 1.0).all()) and bool((q.band_q[zero] == 0).all())
    err = (tq.dequantize_band(q).band - a.band).abs()
    assert bool((err <= q.scales[:, :, None, None] / 2 + 1e-6).all())


def test_dequantize_and_the_xla_oracle(operands):
    jqq, tqq, x = operands["spatial-640"]
    np.testing.assert_array_equal(tq.dequantize_band(tqq).band.numpy(),
                                  np.asarray(jq.dequantize_band(jqq).band))
    got = tq.banded_spmm_quant_xla(tqq, torch.from_numpy(x)).numpy()
    want = np.asarray(jq.banded_spmm_quant_xla(jqq, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_to_feature_major_is_bitwise_equal(operands):
    jqq, tqq, _ = operands["nonsymmetric-ragged-600"]
    jfm, tfm = jq.to_feature_major(jqq), tq.to_feature_major(tqq)
    np.testing.assert_array_equal(tfm.band_qT.numpy(), np.asarray(jfm.band_qT))
    np.testing.assert_array_equal(tfm.scales.numpy(), np.asarray(jfm.scales))
    assert tfm.band_qT.is_contiguous() and (tfm.num_nodes, tfm.bandwidth) == (600, 1)


def test_quantize_activations_fm_is_bitwise_equal():
    rng = np.random.default_rng(4)
    xT_pad = np.zeros((5, 12 * 64), np.float32)  # 12 column blocks, the outer two zero
    xT_pad[:, 64:-64] = rng.standard_normal((5, 10 * 64)) * rng.uniform(0.1, 10, 10 * 64)
    jxq, jxs = jq.quantize_activations_fm(jnp.asarray(xT_pad), 64)
    txq, txs = tq.quantize_activations_fm(torch.from_numpy(xT_pad), 64)
    assert txq.dtype == torch.int8 and txs.shape == (12,)
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(txs.numpy(), np.asarray(jxs))
    assert txs[0] == txs[-1] == 1.0


def jax_kernel(kid, jqq, x):
    """JAX's Pallas kernel in interpret mode, node-major ``[n, F]`` out."""
    if kid == "K3":
        return np.asarray(jq.banded_spmm_quant(jqq, jnp.asarray(x), interpret=True))
    fn = jq.banded_spmm_quant_fm if kid == "K4" else jq.banded_spmm_quant_fm_w8a8
    return np.asarray(fn(jq.to_feature_major(jqq), jnp.asarray(x.T), interpret=True)).T


def port_plain(kid, tqq, x):
    """The port's plain version, node-major ``[n, F]`` out."""
    if kid == "K3":
        return tq.banded_spmm_quant_reference(tqq, torch.from_numpy(x)).numpy()
    fn = tq.banded_spmm_quant_fm_reference if kid == "K4" else tq.banded_spmm_quant_fm_w8a8_reference
    return fn(tq.to_feature_major(tqq), torch.from_numpy(x).T).numpy().T


@pytest.mark.parametrize("kid", ["K3", "K4", "K5"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_kernels_match_jax_interpret(operands, case, kid):
    jqq, tqq, x = operands[case]
    got = port_plain(kid, tqq, x)
    assert got.shape == x.shape
    np.testing.assert_allclose(got, jax_kernel(kid, jqq, x), rtol=RTOL, atol=ATOL)


def test_entry_points_take_the_plain_version_on_cpu(operands):
    _, tqq, x = operands["nonsymmetric-F5"]
    xt = torch.from_numpy(x)
    fm = tq.to_feature_major(tqq)
    counts = [k.launches for k in (tq.banded_spmm_quant_kernel, tq.banded_spmm_quant_fm_kernel,
                                   tq.banded_spmm_quant_fm_w8a8_kernel)]
    assert torch.equal(tq.banded_spmm_quant(tqq, xt), tq.banded_spmm_quant_reference(tqq, xt))
    assert torch.equal(tq.banded_spmm_quant_fm(fm, xt.T), tq.banded_spmm_quant_fm_reference(fm, xt.T))
    assert torch.equal(tq.banded_spmm_quant_fm_w8a8(fm, xt.T),
                       tq.banded_spmm_quant_fm_w8a8_reference(fm, xt.T))
    assert counts == [k.launches for k in (tq.banded_spmm_quant_kernel, tq.banded_spmm_quant_fm_kernel,
                                           tq.banded_spmm_quant_fm_w8a8_kernel)]


@pytest.mark.parametrize("kernel", ["banded_spmm_quant_kernel", "banded_spmm_quant_fm_kernel",
                                    "banded_spmm_quant_fm_w8a8_kernel"])
def test_kernel_wrappers_refuse_cpu_tensors(operands, kernel):
    _, tqq, x = operands["nonsymmetric-ragged-600"]
    q, xt = (tqq, torch.from_numpy(x)) if kernel == "banded_spmm_quant_kernel" else (
        tq.to_feature_major(tqq), torch.from_numpy(x.T.copy()))
    fn = getattr(tq, kernel)
    before = fn.launches
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fn(q, xt)
    assert fn.launches == before


def test_w8a8_plain_version_refuses_blocks_past_its_exactness_bound():
    q = tq.QuantizedBandedMatrixFM(torch.zeros((1, 1, 1041, 1041), dtype=torch.int8),
                                   torch.ones((1, 1)), 1041, 0)
    with pytest.raises(ValueError, match="no longer exact"):
        tq.banded_spmm_quant_fm_w8a8_reference(q, torch.zeros((2, 1041)))


def test_serving_spmm_w8a8_needs_a_feature_major_band(operands):
    _, tqq, _ = operands["spatial-640"]
    with pytest.raises(ValueError, match="feature-major"):
        tq.serving_spmm(tqq, w8a8=True)
    assert tq.serving_spmm(tq.to_feature_major(tqq), w8a8=True, plain=True) is (
        tq.banded_spmm_quant_fm_w8a8_reference)


def test_quantized_hybrid_spmm():
    jg, tg = spatial(640, seed=3, shortcut_frac=0.15)
    jh = jb.to_hybrid(*coo(jg), 640, block=64, bandwidth=1)
    th = tb.to_hybrid(*coo(tg), 640, block=64, bandwidth=1)
    jqh, tqh = jq.quantize_hybrid(jh), tq.quantize_hybrid(th)
    np.testing.assert_array_equal(tqh.band.band_q.numpy(), np.asarray(jqh.band.band_q))
    x = tg.node_features
    got = tq.hybrid_spmm_quant(tqh, torch.from_numpy(x)).numpy()
    want = np.asarray(jq.hybrid_spmm_quant(jqh, jnp.asarray(x), interpret=True))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(tq.hybrid_spmm_quant(tqh, torch.from_numpy(x), plain=True).numpy(), got)
