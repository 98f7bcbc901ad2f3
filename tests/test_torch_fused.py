"""The port's fused forwards on the CPU against JAX's Pallas kernels.

On CPU tensors ``fused_*_forward`` runs the kernel's plain PyTorch version;
it must match JAX's ``fused_*_forward(..., interpret=True)`` (the Pallas
kernel under its interpreter, as ``tests/test_fused.py`` runs it) and the
port's own dense ``model(batch)`` at rtol 1e-4 / atol 1e-5.  The CUDA
kernels themselves are checked on the card by ``test_torch_fused_cuda.py``.
"""

import jax
import numpy as np
import pytest
import torch

import connectome_gnn_tpu.data as jd
import connectome_gnn_tpu.models as jm
import connectome_gnn_tpu_torch.data as td
import connectome_gnn_tpu_torch.models as tm
from connectome_gnn_tpu.ops import fused_pallas as jf
from connectome_gnn_tpu_torch.ops import fused as tf

RTOL, ATOL = 1e-4, 1e-5
KINDS = {
    "gcn": (jm.GCNConnectome, tm.GCNConnectome, jf.fused_gcn_forward, tf.fused_gcn_forward),
    "sage": (jm.GraphSAGEConnectome, tm.GraphSAGEConnectome, jf.fused_sage_forward,
             tf.fused_sage_forward),
}


@pytest.fixture(scope="module")
def batches():
    jg = jd.generate_dataset(num_subjects=6, num_regions=18, seed=4)
    tg = td.generate_dataset(num_subjects=6, num_regions=18, seed=4)
    return jd.collate_dense(jg), td.collate_dense(tg)


def transplant(kind, jbatch, hidden, layers):
    jcls, tcls, _, _ = KINDS[kind]
    jmodel = jcls(in_channels=5, hidden_dim=hidden, num_layers=layers)
    params, state = jmodel.init(jax.random.PRNGKey(0))
    _, state = jmodel.apply(params, state, jbatch, train=True, rng=jax.random.PRNGKey(1))
    tmodel = tcls(in_channels=5, hidden_dim=hidden, num_layers=layers)
    tm.load_jax_params(
        tmodel,
        jax.tree_util.tree_map(np.asarray, params),
        jax.tree_util.tree_map(np.asarray, state),
    )
    return params, state, tmodel.eval()


@pytest.mark.parametrize("layers", [1, 3])
@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_fused_forward_matches_pallas_interpret_and_dense_apply(batches, kind, layers):
    jbatch, tbatch = batches
    params, state, model = transplant(kind, jbatch, hidden=16, layers=layers)
    want = KINDS[kind][2](
        params, state, jbatch.node_features, jbatch.adj, jbatch.node_mask,
        num_layers=layers, interpret=True,
    )
    with torch.no_grad():
        got = KINDS[kind][3](model, tbatch.node_features, tbatch.adj, tbatch.node_mask)
        dense = model(tbatch)
    assert got.shape == want.shape == (6, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_fused_forward_matches_pallas_on_asymmetric_adjacency(batches, kind):
    """Connectomes are symmetric, which would hide a swap of GCN's column
    sum and SAGE's row sum; a random directed adjacency with ragged masks
    does not.  Shapes as the test above, so JAX's compiled program is reused."""
    rng = np.random.default_rng(0)
    B, n = batches[1].node_features.shape[:2]
    mask = np.arange(n)[None, :] < rng.integers(n // 2, n + 1, size=B)[:, None]
    x = rng.normal(size=(B, n, 5)).astype(np.float32) * mask[:, :, None]
    adj = rng.beta(2, 5, (B, n, n)) * (rng.random((B, n, n)) < 0.3)
    adj = (adj * mask[:, :, None] * mask[:, None, :]).astype(np.float32)
    assert not np.allclose(adj, adj.transpose(0, 2, 1))
    params, state, model = transplant(kind, batches[0], hidden=16, layers=3)
    want = KINDS[kind][2](params, state, x, adj, mask, num_layers=3, interpret=True)
    got = KINDS[kind][3](model, *(torch.from_numpy(a) for a in (x, adj, mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_fold_bn_affine_matches_jax(batches, kind):
    params, state, model = transplant(kind, batches[0], hidden=16, layers=2)
    conv_bias = kind == "gcn"
    want = jf.fold_bn_affine(params, state, 2, include_conv_bias=conv_bias)
    got = tf.fold_bn_affine(model, include_conv_bias=conv_bias)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_nonuniform_width_raises(batches, kind):
    _, tbatch = batches
    model = KINDS[kind][1](in_channels=5, hidden_dim=16, num_layers=2).eval()
    w = model.convs[1].linear.weight
    model.convs[1].linear.weight = torch.nn.Parameter(w[:8].clone())
    assert not tf.uniform_hidden_width(model)
    with pytest.raises(ValueError, match="uniform hidden width"):
        KINDS[kind][3](model, tbatch.node_features, tbatch.adj, tbatch.node_mask)


@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_forward_auto_on_cpu_runs_the_model_and_launches_nothing(batches, kind):
    _, tbatch = batches
    model = KINDS[kind][1](in_channels=5, hidden_dim=16).eval()
    before = (tf.fused_gcn_kernel.launches, tf.fused_sage_kernel.launches)
    with torch.no_grad():
        got = tf.forward_auto(model, tbatch)
        want = model(tbatch)
    assert torch.equal(got, want)
    assert (tf.fused_gcn_kernel.launches, tf.fused_sage_kernel.launches) == before
    with pytest.raises(ValueError, match="eval"):
        tf.forward_auto(model.train(), tbatch)


def test_kernel_wrappers_refuse_cpu_tensors(batches):
    """No fallback inside a wrapper: the plain version is chosen by the
    caller for CPU tensors, and the kernel wrapper itself raises."""
    _, tbatch = batches
    model = tm.GCNConnectome(in_channels=5, hidden_dim=16).eval()
    with pytest.raises(ValueError, match="CUDA"):
        tf.fused_gcn_kernel(tbatch.node_features, tbatch.adj, tbatch.node_mask,
                            tf.gcn_weights(model))
    sage = tm.GraphSAGEConnectome(in_channels=5, hidden_dim=16).eval()
    with pytest.raises(ValueError, match="CUDA"):
        tf.fused_sage_kernel(tbatch.node_features, tbatch.adj, tbatch.node_mask,
                             tf.sage_weights(sage))


@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_shape_rule(kind):
    """The main-path shapes (n = 88, H in {64, 128}) and the largest
    routed graph (n = 128, H = 128) fit one block; H = 256 does not."""
    fits = lambda n, H: tf.smem_bytes(kind, n, 5, H, H // 2) <= tf.SMEM_LIMIT_BYTES  # noqa: E731
    assert fits(88, 64) and fits(88, 128) and fits(128, 128)
    assert not fits(128, 256)


def test_kernel_sources_ship_with_the_package():
    from connectome_gnn_tpu_torch.ops import _build

    assert [p.rsplit("/", 1)[-1] for p in _build.sources()] == [
        "band_mma.cu", "bf16_split.cuh", "fused_forward.cu", "row_gather.cu"]
    assert "-gencode" in _build.NVCC_FLAGS and "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
