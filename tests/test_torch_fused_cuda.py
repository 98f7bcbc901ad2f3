"""The fused CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one.  The machine with
the card has no JAX, and ``tests/conftest.py`` imports it, so run them
there without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fused_cuda.py

This file imports no JAX.  Tolerance: rtol 1e-4 / atol 1e-5, the
repository's f32 gate; the kernel and cuBLAS sum in different orders.
"""

import numpy as np
import pytest
import torch

import connectome_gnn_tpu_torch.data as td
import connectome_gnn_tpu_torch.models as tm
from connectome_gnn_tpu_torch.ops import fused as tf

pytestmark = pytest.mark.requires_cuda

RTOL, ATOL = 1e-4, 1e-5
KERNELS = {
    "gcn": (tm.GCNConnectome, tf.gcn_weights, tf.fused_gcn_kernel, tf.fused_gcn_forward_reference),
    "sage": (tm.GraphSAGEConnectome, tf.sage_weights, tf.fused_sage_kernel,
             tf.fused_sage_forward_reference),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def random_model(kind, F, H, L, seed=0):
    model = KERNELS[kind][0](in_channels=F, hidden_dim=H, num_layers=L,
                             generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for bn in model.batch_norms:
            bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, H).astype(np.float32)))
            bn.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.5, H).astype(np.float32)))
            bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, H).astype(np.float32)))
    return model.eval()


def random_inputs(B, n, F, device, seed=0):
    rng = np.random.default_rng(seed)
    mask = np.arange(n)[None, :] < rng.integers(3 * n // 4, n + 1, size=B)[:, None]
    x = rng.normal(size=(B, n, F)).astype(np.float32) * mask[:, :, None]
    adj = rng.beta(2, 5, (B, n, n)) * (rng.random((B, n, n)) < 0.1)
    adj = (adj * mask[:, :, None] * mask[:, None, :]).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (x, adj, mask))


@pytest.mark.parametrize("shape", [(16, 88, 5, 64, 3), (512, 88, 5, 64, 3),
                                   (7, 128, 5, 128, 1), (3, 24, 5, 32, 2)])
@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_kernel_matches_plain_version(cuda, kind, shape):
    B, n, F, H, L = shape
    _, weights, kernel, plain = KERNELS[kind]
    inputs = random_inputs(B, n, F, cuda)
    w = weights(random_model(kind, F, H, L).to(cuda))
    before = kernel.launches
    got = kernel(*inputs, w)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    torch.testing.assert_close(got, plain(*inputs, w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_forward_auto_routes_dense_cuda_batches_to_the_kernel(cuda, kind):
    graphs = td.generate_dataset(num_subjects=8, seed=1)
    model = random_model(kind, 5, 64, 3).to(cuda)
    kernel = KERNELS[kind][2]
    before = kernel.launches
    with torch.no_grad():
        dense = td.collate_dense(graphs, device=cuda)
        got = tf.forward_auto(model, dense)
        assert kernel.launches == before + 1
        coo = tf.forward_auto(model, td.collate_graphs(graphs, device=cuda))
        assert kernel.launches == before + 1
    torch.testing.assert_close(got, coo, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_kernel_raises_on_shapes_past_shared_memory(cuda, kind):
    _, weights, kernel, _ = KERNELS[kind]
    inputs = random_inputs(2, 128, 5, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        kernel(*inputs, weights(random_model(kind, 5, 256, 2).to(cuda)))
