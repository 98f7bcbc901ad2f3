"""The port's BandedNodeGCN and BandedNodeSAGE against the JAX package's,
with JAX's weights carried over by ``load_jax_params``.

JAX initializes, one train-mode ``apply`` gives non-trivial BatchNorm
moments, and the BatchNorm affine is drawn from numpy.  Then:

* float32 ``forward`` (band and hybrid) agrees at rtol 1e-4 / atol 1e-5,
  the repository's float32 gate;
* ``apply_quantized`` (feature-major, row-major, w8a8, hybrid) agrees with
  JAX's ``apply_quantized(interpret=True)`` at rtol 1e-4 / atol 1e-4: the
  same int8 arithmetic summed in another order, through two layers.  The
  kernels round each layer's input to bf16 (int8 for w8a8), and a float32
  summation-order difference upstream flips that rounding for an input
  that lies within float32 noise of a rounding boundary: one activation
  then moves by 2^-8 of itself (a whole int8 step for w8a8), and a logit
  by up to ~3e-4 at these sizes (measured: with float32 activations on
  both sides the same paths agree to 4e-7).  The graphs and weights here
  hold no such input;
* the port's quantized logits meet the JAX package's own quant-versus-f32
  gates (``tests/test_banded_quant.py``): relative Frobenius error < 5e-2
  with argmax agreement > 0.99, and for w8a8 < 8e-2 and > 0.98.

Sizes are the JAX tests': 640 nodes, block 64, degree 6, band 40, hidden
32, two layers, five input channels.
"""

import copy
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import connectome_gnn_tpu.data as jd
import connectome_gnn_tpu.models as jm
import connectome_gnn_tpu.ops.banded as jb
import connectome_gnn_tpu_torch as tp
import connectome_gnn_tpu_torch.ops.banded as tb
from connectome_gnn_tpu_torch.models import load_jax_params

F32_RTOL, F32_ATOL = 1e-4, 1e-5
Q_RTOL, Q_ATOL = 1e-4, 1e-4
GATES = {"bf16": (5e-2, 0.99), "w8a8": (8e-2, 0.98)}
KINDS = {"gcn": (jm.BandedNodeGCN, tp.BandedNodeGCN), "sage": (jm.BandedNodeSAGE, tp.BandedNodeSAGE)}
#: quantized serving paths: (kind, layout, feature_major, w8a8)
PATHS = {
    "gcn-fm": ("gcn", "band", True, False),
    "gcn-rowmajor": ("gcn", "band", False, False),
    "gcn-w8a8": ("gcn", "band", True, True),
    "gcn-hybrid": ("gcn", "hybrid", True, False),
    "sage-fm": ("sage", "band", True, False),
    "sage-rowmajor": ("sage", "band", False, False),
    "sage-hybrid": ("sage", "hybrid", True, False),
}


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def graphs():
    """layout → (JAX adjacency, port adjacency, node features)."""
    out = {}
    for layout, frac in (("band", 0.0), ("hybrid", 0.15)):
        g = jd.generate_spatial_graph(640, degree=6, band=40, seed=11, shortcut_frac=frac)
        coo = (g.edge_index[0], g.edge_index[1], g.edge_weight, 640)
        if layout == "band":
            out[layout] = (jb.to_banded(*coo, block=64), tb.to_banded(*coo, block=64), g.node_features)
        else:
            out[layout] = (jb.to_hybrid(*coo, block=64, bandwidth=1),
                           tb.to_hybrid(*coo, block=64, bandwidth=1), g.node_features)
    return out


@pytest.fixture(scope="module")
def models(graphs):
    """(kind, layout) → (JAX model, params, state, port model in eval mode),
    the BatchNorm moments from one train-mode apply on the graph served."""
    out = {}
    for (kind, (jcls, tcls)), layout in itertools.product(KINDS.items(), graphs):
        ja, _, x = graphs[layout]
        rng = np.random.default_rng(0)
        jmodel = jcls(in_channels=5, hidden_dim=32, num_layers=2)
        params, state = jmodel.init(jax.random.PRNGKey(0))
        params["norms"] = [
            {"scale": jnp.asarray(rng.uniform(0.5, 1.5, 32), jnp.float32),
             "bias": jnp.asarray(rng.normal(0.0, 0.2, 32), jnp.float32)}
            for _ in params["norms"]
        ]
        _, state = jmodel.apply(params, state, ja, jnp.asarray(x), train=True)
        tmodel = tcls(in_channels=5, hidden_dim=32, num_layers=2)
        load_jax_params(tmodel, numpy_tree(params), numpy_tree(state))
        out[kind, layout] = (jmodel, params, state, tmodel.eval())
    return out


@pytest.fixture(scope="module")
def f32_logits(graphs, models):
    """(kind, layout) → the port's float32 eval logits."""
    with torch.no_grad():
        return {
            (kind, layout): models[kind, layout][3](graphs[layout][1],
                                                    torch.from_numpy(graphs[layout][2]))
            for kind in KINDS for layout in graphs
        }


@pytest.fixture(scope="module")
def quantized(graphs, models):
    """path → (the port's quantized logits, JAX's from interpret mode)."""
    out = {}
    for path, (kind, layout, fm, w8a8) in PATHS.items():
        ja, ta, x = graphs[layout]
        jmodel, params, state, tmodel = models[kind, layout]
        kw = {"w8a8": True} if w8a8 else {}
        jq, jnorm = jmodel.prepare_quantized(ja, feature_major=fm)
        want, _ = jmodel.apply_quantized(params, state, jq, jnorm, jnp.asarray(x), interpret=True, **kw)
        tq, tnorm = tmodel.prepare_quantized(ta, feature_major=fm)
        out[path] = (tmodel.apply_quantized(tq, tnorm, torch.from_numpy(x), **kw), np.asarray(want))
    return out


@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_parameter_names_and_count(models, kind):
    _, params, _, tmodel = models[kind, "band"]
    bias = "convs.1.linear.bias" if kind == "sage" else "convs.1.bias"
    keys = set(tmodel.state_dict())
    assert {"convs.0.linear.weight", bias, "batch_norms.1.weight", "batch_norms.1.running_mean",
            "batch_norms.1.running_var", "head.weight", "head.bias"} <= keys
    assert tuple(tmodel.convs[0].linear.weight.shape) == ((32, 10) if kind == "sage" else (32, 5))
    jax_count = sum(int(np.size(leaf)) for leaf in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in tmodel.parameters()) == jax_count


def test_init_is_seeded_by_generator():
    a = tp.BandedNodeGCN(5, 16, generator=torch.Generator().manual_seed(3))
    b = tp.BandedNodeGCN(5, 16, generator=torch.Generator().manual_seed(3))
    for x, y in zip(a.state_dict().values(), b.state_dict().values()):
        assert torch.equal(x, y)


def test_load_jax_params_raises_on_a_mismatch(models):
    _, gcn_params, gcn_state, _ = models["gcn", "band"]
    with pytest.raises((ValueError, RuntimeError)):
        load_jax_params(tp.BandedNodeSAGE(5, 32, num_layers=2), numpy_tree(gcn_params),
                        numpy_tree(gcn_state))
    with pytest.raises(ValueError, match="missing"):
        load_jax_params(tp.GCNConnectome(5, 32, num_layers=2), numpy_tree(gcn_params),
                        numpy_tree(gcn_state))


@pytest.mark.parametrize("layout", ["band", "hybrid"])
@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_f32_forward_matches_jax(graphs, models, f32_logits, kind, layout):
    ja, _, x = graphs[layout]
    jmodel, params, state, _ = models[kind, layout]
    want, _ = jmodel.apply(params, state, ja, jnp.asarray(x))
    got = f32_logits[kind, layout].numpy()
    assert got.shape == (640, 2)
    np.testing.assert_allclose(got, np.asarray(want), rtol=F32_RTOL, atol=F32_ATOL)


@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_train_mode_forward_and_running_moments_match_jax(graphs, models, kind):
    ja, ta, x = graphs["band"]
    jmodel, params, state, tmodel = models[kind, "band"]
    mask = np.arange(640) < 600  # padded rows stay out of the batch moments
    want, new_state = jmodel.apply(params, state, ja, jnp.asarray(x), node_mask=jnp.asarray(mask),
                                   train=True)
    model = copy.deepcopy(tmodel).train()
    got = model(ta, torch.from_numpy(x), node_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=F32_RTOL, atol=F32_ATOL)
    for bn, moments in zip(model.batch_norms, new_state["norms"]):
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(moments["mean"]),
                                   rtol=F32_RTOL, atol=F32_ATOL)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(moments["var"]),
                                   rtol=F32_RTOL, atol=F32_ATOL)


@pytest.mark.parametrize("band_dtype", ["float32", "bfloat16"])
def test_prepare_and_apply_normalized_match_jax(graphs, models, band_dtype):
    ja, ta, x = graphs["band"]
    jmodel, params, state, tmodel = models["gcn", "band"]
    jn, jdinv = jmodel.prepare(ja, band_dtype=band_dtype)
    want, _ = jmodel.apply_normalized(params, state, jn, jdinv, jnp.asarray(x))
    tn, tdinv = tmodel.prepare(ta, band_dtype=band_dtype)
    assert tn.band.dtype == getattr(torch, band_dtype)
    got = tmodel.apply_normalized(tn, tdinv, torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=F32_RTOL, atol=F32_ATOL)
    with pytest.raises(ValueError):
        tmodel.prepare(ta, band_dtype="float16")


@pytest.mark.parametrize("path", list(PATHS))
def test_apply_quantized_matches_jax_interpret(quantized, path):
    got, want = quantized[path]
    assert got.shape == (640, 2) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=Q_RTOL, atol=Q_ATOL)


@pytest.mark.parametrize("path", ["gcn-fm", "gcn-w8a8", "gcn-hybrid", "sage-fm", "sage-hybrid"])
def test_quantized_serving_meets_the_f32_gates(quantized, f32_logits, path):
    kind, layout, _, w8a8 = PATHS[path]
    got, want = quantized[path][0], f32_logits[kind, layout]
    rel = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
    agree = float((got.argmax(1) == want.argmax(1)).float().mean())
    max_rel, min_agree = GATES["w8a8" if w8a8 else "bf16"]
    assert rel < max_rel and agree > min_agree, (rel, agree)


def test_feature_major_and_row_major_serving_agree(quantized):
    np.testing.assert_allclose(quantized["gcn-fm"][0].numpy(), quantized["gcn-rowmajor"][0].numpy(),
                               rtol=Q_RTOL, atol=Q_ATOL)


def test_plain_path_equals_the_default_on_cpu(graphs, models, quantized):
    _, ta, x = graphs["band"]
    tmodel = models["gcn", "band"][3]
    adj_q, dinv = tmodel.prepare_quantized(ta)
    plain = tmodel.apply_quantized(adj_q, dinv, torch.from_numpy(x), w8a8=True, plain=True)
    assert torch.equal(plain, quantized["gcn-w8a8"][0])


def test_sage_normalizer_comes_from_the_f32_band(graphs, models):
    _, ta, _ = graphs["band"]
    _, w_sum = models["sage", "band"][3].prepare_quantized(ta)
    assert torch.equal(w_sum, tb.banded_row_sum(ta))


def test_w8a8_requires_a_feature_major_adjacency(graphs, models):
    _, ta, x = graphs["band"]
    tmodel = models["gcn", "band"][3]
    adj_q, dinv = tmodel.prepare_quantized(ta, feature_major=False)
    with pytest.raises(ValueError, match="feature-major"):
        tmodel.apply_quantized(adj_q, dinv, torch.from_numpy(x), w8a8=True)


def test_apply_quantized_requires_eval_mode(graphs, models):
    _, ta, x = graphs["band"]
    model = copy.deepcopy(models["sage", "band"][3]).train()
    adj_q, w_sum = model.prepare_quantized(ta)
    with pytest.raises(ValueError, match="eval"):
        model.apply_quantized(adj_q, w_sum, torch.from_numpy(x))
