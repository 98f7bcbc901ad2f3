"""The PyTorch port's models against the JAX package's, with JAX's weights.

JAX initializes, one train-mode ``apply`` gives non-trivial BatchNorm
moments, and ``load_jax_params`` carries both into the port.  Eval logits
and embeddings must then agree at the repository's f32 gate (rtol 1e-4,
atol 1e-5, ``bench.py``): the two sum in different orders, nothing more.
"""

import jax
import numpy as np
import pytest
import torch

import connectome_gnn_tpu.data as jd
import connectome_gnn_tpu.models as jm
import connectome_gnn_tpu_torch.data as td
import connectome_gnn_tpu_torch.models as tm
from connectome_gnn_tpu_torch.ops.gcn_norm import gcn_normalize
from connectome_gnn_tpu_torch.ops.segment import coo_spmm, graph_mean_pool, segment_sum

RTOL, ATOL = 1e-4, 1e-5
CLASSES = {"gcn": (jm.GCNConnectome, tm.GCNConnectome),
           "sage": (jm.GraphSAGEConnectome, tm.GraphSAGEConnectome)}


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def data():
    jg = jd.generate_dataset(num_subjects=10, num_regions=18, seed=7)
    tg = td.generate_dataset(num_subjects=10, num_regions=18, seed=7)
    return {
        "coo": (jd.collate_graphs(jg), td.collate_graphs(tg)),
        "dense": (jd.collate_dense(jg), td.collate_dense(tg)),
    }


@pytest.fixture(scope="module")
def transplanted(data):
    """Per kind: JAX model, params, non-trivial state, and the port model."""
    out = {}
    for kind, (jcls, tcls) in CLASSES.items():
        jmodel = jcls(in_channels=5, hidden_dim=24, num_layers=3)
        params, state = jmodel.init(jax.random.PRNGKey(0))
        _, state = jmodel.apply(
            params, state, data["dense"][0], train=True, rng=jax.random.PRNGKey(1)
        )
        tmodel = tcls(in_channels=5, hidden_dim=24, num_layers=3)
        tm.load_jax_params(tmodel, numpy_tree(params), numpy_tree(state))
        out[kind] = (jmodel, params, state, tmodel.eval())
    return out


def test_parameter_counts_match_reference():
    assert tm.GCNConnectome(in_channels=5, hidden_dim=64).num_params() == 11_234
    assert tm.GraphSAGEConnectome(in_channels=5, hidden_dim=64).num_params() == 19_746


@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_parameter_names_are_reference_keys(kind):
    keys = set(CLASSES[kind][1](in_channels=5, hidden_dim=16, num_layers=2).state_dict())
    bias = "convs.1.linear.bias" if kind == "sage" else "convs.1.bias"
    assert {
        "convs.0.linear.weight", bias, "batch_norms.1.weight",
        "batch_norms.1.running_mean", "batch_norms.1.running_var",
        "classifier.0.weight", "classifier.0.bias", "classifier.3.weight",
    } <= keys


def test_init_is_seeded_by_generator():
    a = tm.GCNConnectome(5, 16, generator=torch.Generator().manual_seed(3))
    b = tm.GCNConnectome(5, 16, generator=torch.Generator().manual_seed(3))
    c = tm.GCNConnectome(5, 16, generator=torch.Generator().manual_seed(4))
    for x, y in zip(a.state_dict().values(), b.state_dict().values()):
        assert torch.equal(x, y)
    assert not torch.equal(a.convs[0].linear.weight, c.convs[0].linear.weight)


@pytest.mark.parametrize("layout", ["coo", "dense"])
@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_eval_logits_and_embeddings_match_jax(data, transplanted, kind, layout):
    jmodel, params, state, tmodel = transplanted[kind]
    jbatch, tbatch = data[layout]
    want_logits, _ = jmodel.apply(params, state, jbatch, train=False)
    want_emb, _ = jmodel.encode(params, state, jbatch, train=False)
    with torch.no_grad():
        got_logits = tmodel(tbatch)
        got_emb = tmodel.encode(tbatch)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_emb.numpy(), np.asarray(want_emb), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("layout", ["coo", "dense"])
@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_train_mode_batchnorm_moments_match_jax(data, kind, layout):
    """Masked train-mode moments (biased normalize, unbiased running
    update, momentum 0.1) equal JAX's; dropout 0 keeps RNG out of it."""
    jcls, tcls = CLASSES[kind]
    jmodel = jcls(in_channels=5, hidden_dim=16, num_layers=2, dropout=0.0)
    params, state = jmodel.init(jax.random.PRNGKey(2))
    jbatch, tbatch = data[layout]
    want_logits, new_state = jmodel.apply(params, state, jbatch, train=True)
    tmodel = tcls(in_channels=5, hidden_dim=16, num_layers=2, dropout=0.0)
    tm.load_jax_params(tmodel, numpy_tree(params), numpy_tree(state))
    got_logits = tmodel.train()(tbatch)
    np.testing.assert_allclose(
        got_logits.detach().numpy(), np.asarray(want_logits), rtol=RTOL, atol=ATOL
    )
    for bn, s in zip(tmodel.batch_norms, new_state["norms"]):
        np.testing.assert_allclose(bn.running_mean.numpy(), s["mean"], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(bn.running_var.numpy(), s["var"], rtol=RTOL, atol=ATOL)
        assert int(bn.num_batches_tracked) == 1


@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_reference_state_dict_round_trips_through_jax_compat(transplanted, kind):
    _, params, state, _ = transplanted[kind]
    sd = tm.reference_state_dict_from_params(
        numpy_tree(params), numpy_tree(state), sage=kind == "sage"
    )
    back_params, back_state = jm.params_from_reference_state_dict(sd, num_layers=3)
    for a, b in zip(jax.tree_util.tree_leaves((params, state)),
                    jax.tree_util.tree_leaves((back_params, back_state))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_reference_checkpoint_loads_with_load_state_dict(transplanted):
    """Reference-named keys (incl. num_batches_tracked) load strictly."""
    _, _, _, src = transplanted["gcn"]
    dst = tm.GCNConnectome(in_channels=5, hidden_dim=24, num_layers=3)
    dst.load_state_dict(src.state_dict(), strict=True)
    for a, b in zip(src.state_dict().values(), dst.state_dict().values()):
        assert torch.equal(a, b)


def test_load_jax_params_rejects_mismatch(transplanted):
    _, params, state, _ = transplanted["gcn"]
    with pytest.raises((ValueError, RuntimeError)):
        tm.load_jax_params(
            tm.GraphSAGEConnectome(in_channels=5, hidden_dim=24, num_layers=3),
            numpy_tree(params), numpy_tree(state),
        )


@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_forward_invariant_to_padding(transplanted, kind):
    """Budgets far past the contents: padded edges (id P, weight 0) and
    padded nodes (graph id B) stay inert in both layouts."""
    _, _, _, model = transplanted[kind]
    tg = td.generate_dataset(num_subjects=4, num_regions=15, seed=2)
    with torch.no_grad():
        tight = model(td.collate_graphs(tg, node_multiple=1, edge_multiple=1))
        padded = model(td.collate_graphs(tg, num_graphs=6, node_budget=512, edge_budget=4096))
        dense = model(td.collate_dense(tg, node_multiple=1))
        dense_padded = model(td.collate_dense(tg, num_graphs=6, node_budget=40))
    np.testing.assert_allclose(padded[:4].numpy(), tight.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dense.numpy(), tight.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dense_padded[:4].numpy(), tight.numpy(), rtol=RTOL, atol=ATOL)


def test_train_mode_moments_invariant_to_padding():
    tg = td.generate_dataset(num_subjects=4, num_regions=15, seed=2)
    tight = td.collate_graphs(tg, node_multiple=1, edge_multiple=1)
    padded = td.collate_graphs(tg, node_budget=512, edge_budget=4096)
    states = []
    for batch in (tight, padded):
        model = tm.GCNConnectome(in_channels=5, hidden_dim=16, dropout=0.0).train()
        model(batch)
        states.append([bn.running_var.clone() for bn in model.batch_norms])
    for a, b in zip(*states):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)


class TestPaddingIds:
    """Trap (a): out-of-range padding ids are dropped or clamped, never an
    index error, exactly where JAX drops or clamps them."""

    def test_segment_sum_drops_one_past_the_end(self):
        data = torch.arange(12, dtype=torch.float32).reshape(6, 2)
        ids = torch.tensor([0, 2, 3, 1, 3, 3])  # 3 == num_segments: padding
        got = segment_sum(data, ids, 3)
        np.testing.assert_array_equal(got.numpy(), [[0, 1], [6, 7], [2, 3]])

    def test_mean_pool_ignores_padded_nodes(self):
        emb = torch.tensor([[1.0], [3.0], [100.0]])
        got = graph_mean_pool(emb, torch.tensor([0, 0, 1]), 1)
        np.testing.assert_allclose(got.numpy(), [[2.0]], rtol=1e-6)

    def test_coo_spmm_and_normalize_with_padded_edges(self):
        """Padded edges hold id P in both endpoints and weight 0."""
        P = 3
        senders = torch.tensor([1, 0, 2, P, P])
        receivers = torch.tensor([0, 1, 1, P, P])
        w = torch.tensor([0.5, 2.0, 1.0, 0.0, 0.0])
        x = torch.tensor([[1.0], [10.0], [100.0]])
        got = coo_spmm(w, senders, receivers, x, P)
        np.testing.assert_allclose(got.numpy(), [[5.0], [102.0], [0.0]])
        norm = gcn_normalize(senders, receivers, w, P)
        np.testing.assert_allclose(norm.edge_norm[3:].numpy(), [0.0, 0.0])
        deg = np.array([2.0, 0.5, 1.0]) + 1.0
        np.testing.assert_allclose(norm.deg_inv_sqrt.numpy(), (deg + 1e-8) ** -0.5, rtol=1e-6)
