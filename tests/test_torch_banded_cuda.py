"""The int8 band kernels K3, K4 and K5 against their plain PyTorch versions,
on the card.

Every test here needs a CUDA card and skips without one.  The machine with
the card has no JAX, and ``tests/conftest.py`` imports it, so run them
there without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_banded_cuda.py

This file imports no JAX.  Tolerances: kernel against plain version rtol
1e-5 / atol 1e-5 (the same exact products, float32 sums in another order);
quantized model against its plain path rtol 1e-4 / atol 1e-4.
"""

import numpy as np
import pytest
import torch

import connectome_gnn_tpu_torch as tp
from connectome_gnn_tpu_torch.ops import banded as tb
from connectome_gnn_tpu_torch.ops import banded_quant as bq

pytestmark = pytest.mark.requires_cuda

RTOL, ATOL = 1e-5, 1e-5
SERVE_RTOL, SERVE_ATOL = 1e-4, 1e-4
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
                                   (16, 2, 256, 4000, 64)])
def test_kernel_matches_plain_version(cuda, kid, shape):
    nb, W, block, n, F = shape
    q = random_band(nb, W, block, n, seed=sum(shape), device=cuda)
    x = torch.from_numpy(np.random.default_rng(n).standard_normal((n, F)).astype(np.float32)).to(cuda)
    kernel, plain, _ = KERNELS[kid]
    before = kernel.launches
    got = kernel(*operands(kid, q, x))
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    torch.testing.assert_close(got, plain(*operands(kid, q, x)), rtol=RTOL, atol=ATOL)


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
