"""The int8 band kernels K3, K4 and K5 against their plain PyTorch versions,
on the card.  All three run on the tensor-core body (``csrc/band_mma.cu``):
K3 role A and K4 role B over the int8 band, K5 role A's schedule on s8 x s8
products.

Every test here needs a CUDA card and skips without one.  The machine with
the card has no JAX, and ``tests/conftest.py`` imports it, so run them
there without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_banded_cuda.py

This file imports no JAX.  Tolerances: kernel against plain version rtol
1e-5 / atol 1e-5 (the same exact products, float32 sums in another order);
K5 bit for bit (each tile's dot exact in int32 and in float32, then scaled
and added in the plain version's order, each rounding apart), also at a
saturated band and x of ±127 at b = 256, where each dot reaches 127²·256;
quantized model against its plain path rtol 1e-4 / atol 1e-4.  The shapes
take each kernel through a ragged tail, W = 0, F = 5, F = 1 and F = 130
(three of K3's 64-feature units), blocks of 100 and 16 (K3 pads them to
112 and 16) and the main shape's 256-node block.  A band whose scales and
activations span six decades each way shows whether K3's and K4's
tensor-core accumulation differs from IEEE float32 sums in another order:
each output is held to 1e-5 of the sum of its products' magnitudes.  K4's
tensor map masks its senders: at row block 0 with W >= 1 its first
coordinates are negative, and an ``xT`` wider than the graph holds values
past ``num_nodes`` that must not enter.  A stage reads 64 senders, so at
blocks of 16, 32 and 48 it reaches into the next node blocks: an Inf or a
NaN of x in one interior block reaches no row block that the plain version
keeps finite, forward and over the transposed band (K4's backward).
"""

import numpy as np
import pytest
import torch

import connectome_gnn_tpu_torch as tp
from connectome_gnn_tpu_torch.ops import band_mma
from connectome_gnn_tpu_torch.ops import banded as tb
from connectome_gnn_tpu_torch.ops import banded_quant as bq

pytestmark = pytest.mark.requires_cuda

RTOL, ATOL = 1e-5, 1e-5
SERVE_RTOL, SERVE_ATOL = 1e-4, 1e-4
#: |kernel - plain| against the plain version over |A_q|, |scales| and |x|
MAGNITUDE_RTOL = 1e-5
KERNELS = {
    "K3": (bq.banded_spmm_quant_kernel, bq.banded_spmm_quant_reference, False),
    "K4": (bq.banded_spmm_quant_fm_kernel, bq.banded_spmm_quant_fm_reference, True),
    "K5": (bq.banded_spmm_quant_fm_w8a8_kernel, bq.banded_spmm_quant_fm_w8a8_reference, True),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def random_band(nb, W, block, n, seed, device):
    """Random non-symmetric int8 tiles (70 % zeros, tile (0, 0) all zero
    with scale 1), so a swapped tile axis cannot go unseen."""
    rng = np.random.default_rng(seed)
    shape = (nb, 2 * W + 1, block, block)
    q = (rng.integers(-127, 128, shape) * (rng.random(shape) < 0.3)).astype(np.int8)
    scales = rng.uniform(1e-3, 1.1e-2, shape[:2]).astype(np.float32)
    q[0, 0], scales[0, 0] = 0, 1.0
    return bq.QuantizedBandedMatrix(torch.from_numpy(q).to(device),
                                    torch.from_numpy(scales).to(device), n, W)


def operands(kid, q, x):
    return (bq.to_feature_major(q), x.T.contiguous()) if KERNELS[kid][2] else (q, x)


@pytest.mark.parametrize("kid", list(KERNELS))
@pytest.mark.parametrize("shape", [(10, 1, 64, 640, 16), (10, 1, 64, 600, 16), (10, 0, 64, 600, 16),
                                   (10, 2, 64, 640, 5), (7, 1, 100, 650, 70),
                                   (16, 2, 256, 4000, 64), (10, 2, 64, 640, 1),
                                   (6, 1, 64, 350, 130), (12, 1, 16, 180, 8)])
def test_kernel_matches_plain_version(cuda, kid, shape):
    nb, W, block, n, F = shape
    q = random_band(nb, W, block, n, seed=sum(shape), device=cuda)
    x = torch.from_numpy(np.random.default_rng(n).standard_normal((n, F)).astype(np.float32)).to(cuda)
    kernel, plain, _ = KERNELS[kid]
    before = kernel.launches
    got = kernel(*operands(kid, q, x))
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = plain(*operands(kid, q, x))
    if kid == "K5":
        assert got.shape == want.shape and torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("W", [1, 2])
def test_k5_saturated_band_bit_for_bit(cuda, W):
    """A non-symmetric band and x of ±127 at b = 256: one tile all +127
    against a frame block all +127, so its dot is 127²·256, the largest
    the block allows; K5 equals its plain version bit for bit."""
    nb, block, F = 6, 256, 64
    n = nb * block - 37
    rng = np.random.default_rng(W)
    band = (127 * rng.choice([-1, 1], (nb, 2 * W + 1, block, block))).astype(np.int8)
    band[2, W] = 127
    band[3, W + 1] = np.triu(np.full((block, block), 127, np.int8))  # not symmetric
    scales = rng.uniform(1e-3, 1.1e-2, (nb, 2 * W + 1)).astype(np.float32)
    q = bq.QuantizedBandedMatrixFM(torch.from_numpy(band).to(cuda), torch.from_numpy(scales).to(cuda), n, W)
    xT = torch.from_numpy(rng.choice([-3.0, 3.0], (F, n)).astype(np.float32)).to(cuda)
    xT[:, 2 * block:3 * block] = 3.0
    xq, _ = bq.quantize_activations_padded(q, xT)
    assert int(xq[:, W * block:(W + nb) * block - 37].abs().min()) == 127
    got = bq.banded_spmm_quant_fm_w8a8_kernel(q, xT)
    want = bq.banded_spmm_quant_fm_w8a8_reference(q, xT)
    assert bool(torch.isfinite(got).all()) and torch.equal(got, want)


@pytest.mark.parametrize("shape", [(20, 2, 256, 5000, 64), (7, 1, 100, 650, 70)])
def test_k3_accumulation_over_six_decades(cuda, shape):
    """Scales and activations spread log-uniformly over three decades each
    way: each output of K3 within 1e-5 of the sum of its products'
    magnitudes."""
    nb, W, block, n, F = shape
    q = random_band(nb, W, block, n, seed=sum(shape), device=cuda)
    rng = np.random.default_rng(n + F)
    scales = 10.0 ** rng.uniform(-3, 3, q.scales.shape)
    x = rng.standard_normal((n, F)) * 10.0 ** rng.uniform(-3, 3, (n, F))
    q = q._replace(scales=torch.from_numpy(scales.astype(np.float32)).to(cuda))
    x = torch.from_numpy(x.astype(np.float32)).to(cuda)
    got = bq.banded_spmm_quant_kernel(q, x)
    want = bq.banded_spmm_quant_reference(q, x)
    magnitude = bq.banded_spmm_quant_reference(q._replace(band_q=q.band_q.abs()), x.abs())
    assert bool(((got - want).abs() <= MAGNITUDE_RTOL * magnitude).all())


@pytest.mark.parametrize("shape", [(20, 2, 256, 5000, 64), (7, 1, 100, 650, 70)])
def test_k4_accumulation_over_six_decades(cuda, shape):
    """As K3's: each output of K4 within 1e-5 of the sum of its products'
    magnitudes."""
    nb, W, block, n, F = shape
    q = bq.to_feature_major(random_band(nb, W, block, n, seed=sum(shape), device=cuda))
    rng = np.random.default_rng(n + F)
    scales = 10.0 ** rng.uniform(-3, 3, q.scales.shape)
    x = rng.standard_normal((F, n)) * 10.0 ** rng.uniform(-3, 3, (F, n))
    q = q._replace(scales=torch.from_numpy(scales.astype(np.float32)).to(cuda))
    xT = torch.from_numpy(x.astype(np.float32)).to(cuda)
    got = bq.banded_spmm_quant_fm_kernel(q, xT)
    want = bq.banded_spmm_quant_fm_reference(q, xT)
    magnitude = bq.banded_spmm_quant_fm_reference(q._replace(band_qT=q.band_qT.abs()), xT.abs())
    assert bool(((got - want).abs() <= MAGNITUDE_RTOL * magnitude).all())


def test_k4_launch_alone_equals_the_wrapper(cuda):
    """At the main shape's layout (b = 256, F = 64) K4's wrapper hands the
    kernel the band and ``xT`` as they are: its launch alone gives the
    entry point's output bit for bit."""
    nb, W, block, n, F = 12, 2, 256, 3000, 64
    q = bq.to_feature_major(random_band(nb, W, block, n, seed=6, device=cuda))
    xT = torch.randn(F, n, device=cuda)
    x, x_block, x_cols = band_mma.fm_x_operand(xT, n, nb, block)
    assert x is xT and band_mma.pad_band(q.band_qT) is q.band_qT
    alone = band_mma.launch_fm_int8("K4", q.band_qT, q.scales, xT, x_block, x_cols, n, W, block)
    assert torch.equal(alone, bq.banded_spmm_quant_fm(q, xT))


@pytest.mark.parametrize("shape", [(10, 2, 64, 600, 16), (8, 1, 256, 1900, 64), (9, 2, 32, 270, 5)])
def test_k4_map_masks_senders_outside_the_graph(cuda, shape):
    """``xT`` is a view of a wider array whose columns past ``num_nodes``
    hold 1e30: K4's map, of extent ``num_nodes``, reads them as zeros, and
    row block 0's coordinates below sender 0 as zeros too."""
    nb, W, block, n, F = shape
    q = bq.to_feature_major(random_band(nb, W, block, n, seed=sum(shape), device=cuda))
    wide = torch.full((F, nb * block + 64), 1e30, device=cuda)
    wide[:, :n] = torch.randn(F, n, device=cuda)
    xT = wide[:, :n]
    x, _, _ = band_mma.fm_x_operand(xT, n, nb, block)
    assert x is xT
    got = bq.banded_spmm_quant_fm_kernel(q, xT)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, bq.banded_spmm_quant_fm_reference(q, xT.contiguous()),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("value", [float("inf"), float("nan")], ids=["inf", "nan"])
@pytest.mark.parametrize("W", [0, 1, 2])
@pytest.mark.parametrize("block", [16, 32, 48])
@pytest.mark.parametrize("kid", ["K4", "K4 backward"])
def test_k4_reads_no_sender_past_its_node_block(cuda, kid, block, W, value):
    """A non-finite x in one interior node block k: where the block is not
    a multiple of 64, a 64-sender stage of role B reads on into the next
    node blocks through K4's 2-D map, which the kernel masks.  K4, and K4's
    backward launch over the transposed band, equal the plain version NaN
    for NaN, and every row block that does not read block k (|rb - k| > W)
    is finite."""
    nb, F = 12, 8
    n = nb * block - 5
    q = random_band(nb, W, block, n, seed=block + W, device=cuda)
    qf = bq.transposed_feature_major(q) if kid == "K4 backward" else bq.to_feature_major(q)
    kernel = bq.banded_spmm_quant_fm_grad_kernel if kid == "K4 backward" else bq.banded_spmm_quant_fm_kernel
    xT = torch.randn(F, n, device=cuda)
    k = nb // 2
    xT[2, k * block + 3] = value
    got = kernel(qf, xT)
    want = bq.banded_spmm_quant_fm_reference(qf, xT)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL, equal_nan=True)
    reads_k = (torch.arange(n, device=cuda) // block - k).abs() <= W
    assert bool(torch.isfinite(want[:, ~reads_k]).all()) and not bool(torch.isfinite(want[:, reads_k]).all())
    assert bool(torch.isfinite(got[:, ~reads_k]).all())


def test_k3_launch_alone_equals_the_wrapper(cuda):
    """On the operands K3's wrapper prepares, role A's launch gives the
    entry point's output bit for bit."""
    nb, W, block, n, F = 7, 1, 100, 650, 70
    q = random_band(nb, W, block, n, seed=5, device=cuda)
    x = torch.randn(n, F, device=cuda)
    frame = band_mma.rowmajor_frame(x, n, nb, W, block)
    alone = band_mma.launch_rowmajor("K3", band_mma.pad_band(q.band_q), frame, n, W, block, F, q.scales)
    assert torch.equal(alone, bq.banded_spmm_quant(q, x))
    with pytest.raises(ValueError, match="padded band"):
        band_mma.launch_rowmajor("K3", q.band_q, frame, n, W, block, F, q.scales)


@pytest.mark.parametrize("kid", list(KERNELS))
def test_entry_points_launch_the_kernel_on_cuda_tensors(cuda, kid):
    q = random_band(10, 1, 64, 600, seed=1, device=cuda)
    x = torch.randn(600, 16, device=cuda)
    entry = {"K3": bq.banded_spmm_quant, "K4": bq.banded_spmm_quant_fm,
             "K5": bq.banded_spmm_quant_fm_w8a8}[kid]
    kernel = KERNELS[kid][0]
    before = kernel.launches
    entry(*operands(kid, q, x))
    assert kernel.launches == before + 1


def test_kernels_refuse_operands_they_do_not_take(cuda):
    q = random_band(10, 1, 64, 600, seed=2, device=cuda)
    x = torch.randn(600, 16, device=cuda)
    with pytest.raises(ValueError, match="unit inner stride"):
        bq.banded_spmm_quant_fm_kernel(bq.to_feature_major(q), x.T)
    with pytest.raises(ValueError, match="float32"):
        bq.banded_spmm_quant_kernel(q, x.double())
    with pytest.raises(ValueError, match="share"):
        bq.banded_spmm_quant_kernel(q._replace(scales=q.scales.cpu()), x)


def test_to_banded_on_the_card_matches_the_host_build(cuda):
    g = tp.generate_spatial_graph(600, degree=6, band=40, seed=0)
    coo = (g.edge_index[0], g.edge_index[1], g.edge_weight, 600)
    host = tb.to_banded(*coo, block=64)
    card = tb.to_banded(*coo, block=64, device=cuda)
    torch.testing.assert_close(card.band.cpu(), host.band, rtol=1e-6, atol=1e-6)


#: (model, layout, feature_major, w8a8, the kernel it must launch)
PATHS = {
    "gcn-fm": (tp.BandedNodeGCN, "band", True, False, "K4"),
    "gcn-w8a8": (tp.BandedNodeGCN, "band", True, True, "K5"),
    "gcn-rowmajor": (tp.BandedNodeGCN, "band", False, False, "K3"),
    "gcn-hybrid": (tp.BandedNodeGCN, "hybrid", True, False, "K3"),
    "sage-fm": (tp.BandedNodeSAGE, "band", True, False, "K4"),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_serving_path_runs_its_kernel_once_per_layer(cuda, path):
    cls, layout, fm, w8a8, kid = PATHS[path]
    g = tp.generate_spatial_graph(4000, degree=12, band=256, seed=3,
                                  shortcut_frac=0.1 if layout == "hybrid" else 0.0)
    coo = (g.edge_index[0], g.edge_index[1], g.edge_weight, 4000)
    adj = (tb.to_hybrid(*coo, block=256, bandwidth=1, device=cuda) if layout == "hybrid"
           else tb.to_banded(*coo, block=256, device=cuda))
    x = torch.from_numpy(g.node_features).to(cuda)
    model = cls(in_channels=5, hidden_dim=64, num_layers=2,
                generator=torch.Generator().manual_seed(0)).to(cuda).eval()
    adj_q, norm = model.prepare_quantized(adj, feature_major=fm)
    kw = {"w8a8": True} if w8a8 else {}
    before = {k: v[0].launches for k, v in KERNELS.items()}
    got = model.apply_quantized(adj_q, norm, x, **kw)
    torch.cuda.synchronize()
    launched = {k: v[0].launches - before[k] for k, v in KERNELS.items()}
    assert launched == {k: 2 if k == kid else 0 for k in KERNELS}
    torch.testing.assert_close(got, model.apply_quantized(adj_q, norm, x, plain=True, **kw),
                               rtol=SERVE_RTOL, atol=SERVE_ATOL)
