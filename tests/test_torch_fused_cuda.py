"""The fused CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one.  The machine with
the card has no JAX, and ``tests/conftest.py`` imports it, so run them
there without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fused_cuda.py

This file imports no JAX.  Tolerance: rtol 1e-4 / atol 1e-5, the
repository's f32 gate; the kernel (six bfloat16 products of an exact split
on the tensor cores) and cuBLAS sum in different orders.  The shapes take
every cluster size the rule picks at n = 88 (B = 1 and 16: 6 CTAs a graph;
48: 5; 64: 4; 80: 3; 100: 2; 512: 1), n = 128 (7 graphs: 8; 36: 7), n = 24 and
n = 40 (not a multiple of 16) with H = 32, 36 (not a multiple of 8), 37 (odd,
with F = 7), 72 (nine n8 tiles) and 128; K2's staged z (past 128 features,
H = 264); and the compact layout (the padded strides do not fit at one CTA a
graph: n = 128 with H = 161 for K1, 151 for K2, odd strides).
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


#: (B, n, F, H, L)
SHAPES = [(16, 88, 5, 64, 3), (512, 88, 5, 64, 3), (7, 128, 5, 128, 1), (3, 24, 5, 32, 2),
          (1, 88, 5, 64, 3), (48, 88, 5, 64, 3), (64, 88, 5, 64, 3), (80, 88, 5, 64, 3),
          (100, 88, 5, 64, 3), (36, 128, 5, 64, 2), (5, 40, 5, 32, 2), (5, 40, 5, 128, 2), (200, 40, 5, 128, 2),
          (5, 40, 5, 72, 2), (300, 40, 5, 72, 2), (3, 24, 5, 264, 1), (5, 40, 5, 36, 2), (5, 40, 7, 37, 2)]
#: (B, n, F, H, L) that take the compact layout, per kernel
COMPACT_SHAPES = {"gcn": (140, 128, 5, 161, 1), "sage": (140, 128, 5, 151, 1)}
#: (kind, n, F, H, H2, cs) -> the layout's bytes, as tests/test_torch_fused_mma.py
#: computes them
LAYOUT_BYTES = {("gcn", 88, 5, 64, 32, 1): 83552, ("sage", 88, 5, 64, 32, 1): 88160,
                ("gcn", 88, 5, 64, 32, 6): 36320, ("sage", 88, 5, 64, 32, 6): 40640,
                ("gcn", 128, 5, 128, 64, 1): 207616, ("sage", 128, 5, 128, 64, 1): 216320,
                ("gcn", 128, 5, 161, 80, 1): 231264, ("sage", 128, 5, 151, 75, 1): 230668,
                ("gcn", 40, 7, 37, 18, 3): 12008, ("sage", 24, 5, 264, 132, 2): 61520}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_kernel_matches_plain_version(cuda, kind, shape):
    check_kernel(cuda, kind, shape)


@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_kernel_matches_plain_version_with_the_compact_layout(cuda, kind):
    B, n, *_ = COMPACT_SHAPES[kind]
    assert tf.cluster_size(B, n, torch.cuda.get_device_properties(cuda).multi_processor_count) == 1
    check_kernel(cuda, kind, COMPACT_SHAPES[kind])


def test_the_layout_is_the_emulations(cuda):
    from connectome_gnn_tpu_torch.ops._build import library

    lib = library()
    for (kind, n, F, H, H2, cs), want in LAYOUT_BYTES.items():
        assert lib.cgt_fused_smem_bytes(int(kind == "sage"), n, F, H, H2, cs) == want, (kind, n, H, cs)


@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_the_layout_fits_every_routed_shape(cuda, kind):
    """The source's own count, at one CTA a graph (the most), for n up to
    128, three input widths and every H the routing rule admits."""
    from connectome_gnn_tpu_torch.ops._build import library

    lib = library()
    for n in range(1, tf.MAX_FUSED_NODES + 1):
        for F in (1, 5, 200):
            H = 1
            while tf.smem_bytes(kind, n, F, H, H // 2) <= tf.SMEM_LIMIT_BYTES:
                got = lib.cgt_fused_smem_bytes(int(kind == "sage"), n, F, H, H // 2, 1)
                assert got <= tf.SMEM_LIMIT_BYTES, (kind, n, F, H, got)
                H += 1


def check_kernel(cuda, kind, shape):
    B, n, F, H, L = shape
    _, weights, kernel, plain = KERNELS[kind]
    inputs = random_inputs(B, n, F, cuda)
    w = weights(random_model(kind, F, H, L).to(cuda))
    before = kernel.launches
    got = kernel(*inputs, w)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    torch.testing.assert_close(got, plain(*inputs, w), rtol=RTOL, atol=ATOL)


def test_the_shapes_take_every_cluster_size(cuda):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    picked = {tf.cluster_size(B, n, sms) for B, n, *_ in SHAPES}
    assert picked == set(range(1, tf.MAX_CLUSTER + 1)), picked


@pytest.mark.parametrize("kind", ["gcn", "sage"])
@pytest.mark.parametrize("B", [1, 16, 512])
def test_two_launches_give_the_same_bits(cuda, kind, B):
    _, weights, kernel, _ = KERNELS[kind]
    inputs = random_inputs(B, 88, 5, cuda, seed=B)
    w = weights(random_model(kind, 5, 64, 3).to(cuda))
    first = kernel(*inputs, w)
    second = kernel(*inputs, w)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))


@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_a_cluster_the_kernel_cannot_take_raises(cuda, kind, monkeypatch):
    """A cluster of 16 CTAs (past the portable 8, and more than n = 88 has
    tiles) is refused: the wrapper raises and neither retries with another
    size nor runs the plain version."""
    _, weights, kernel, _ = KERNELS[kind]
    inputs = random_inputs(4, 88, 5, cuda)
    w = weights(random_model(kind, 5, 64, 3).to(cuda))

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(tf, "cluster_size", lambda B, n, sm_count: 16)
    monkeypatch.setattr(tf, f"fused_{kind}_forward_reference", no_plain)
    before = kernel.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        kernel(*inputs, w)
    assert kernel.launches == before


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
