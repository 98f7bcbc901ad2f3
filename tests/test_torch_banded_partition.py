"""The port's band- and hybrid-partitioned giant-graph models and the 2-D
(data × edge) step against the JAX package, on the CPU.

Graphs of n = 768 nodes, block 32, W = 2 (``tests/test_hybrid_partition.py:29``,
``tests/test_mesh2d.py:31``).  Partitions, stacks and block diagonals are
bitwise JAX's (index dtypes aside).  With JAX's weights carried over:
logits at rtol 1e-4 / atol 1e-5 against JAX's sharded models and the
port's unsharded ones, and one step's gradients (an SGD step at lr 1) at
the same gate against JAX's step; the 2-D step also against one device on
the cohort's block diagonal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from functools import partial
from jax.sharding import PartitionSpec as P

import connectome_gnn_tpu.data as jd
import connectome_gnn_tpu.ops as jops
import connectome_gnn_tpu.parallel as jp

import connectome_gnn_tpu_torch.data as td
import connectome_gnn_tpu_torch.ops as tops
import connectome_gnn_tpu_torch.parallel as tp
from connectome_gnn_tpu_torch.models import BandedNodeGCN, BandedNodeSAGE
from connectome_gnn_tpu_torch.models.compat import (
    load_jax_params,
    reference_state_dict_from_params,
)

D = 4
RTOL, ATOL = 1e-4, 1e-5
BAND_FIELDS = ("band", "node_features", "node_mask", "labels", "label_mask")
REM_FIELDS = ("rem_weights", "rem_receivers", "rem_src_slot", "send_idx")
FAMILIES = {"gcn": (jp.ShardedBandedGCN, tp.ShardedBandedGCN, BandedNodeGCN),
            "sage": (jp.ShardedBandedSAGE, tp.ShardedBandedSAGE, BandedNodeSAGE)}


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def same(a, b, what):
    a, b = np.asarray(a), b.numpy()
    assert a.size == b.size, what
    np.testing.assert_array_equal(a.reshape(b.shape), b.astype(a.dtype), err_msg=what)


def assert_partitions_equal(jpart, tpart):
    banded_j = getattr(jpart, "banded", jpart)
    banded_t = getattr(tpart, "banded", tpart)
    for f in BAND_FIELDS:
        same(getattr(banded_j, f), getattr(banded_t, f), f)
    if hasattr(tpart, "rem_weights"):
        for f in REM_FIELDS:
            same(getattr(jpart, f), getattr(tpart, f), f)
    assert (jpart.num_shards, jpart.bandwidth) == (tpart.num_shards, tpart.bandwidth)


def spatial(seed, shortcut_frac=0.0):
    kw = dict(degree=6, band=40, seed=seed, shortcut_frac=shortcut_frac)
    g, tg = jd.generate_spatial_graph(768, **kw), td.generate_spatial_graph(768, **kw)
    labels = (g.degree() > np.median(g.degree())).astype(np.int32)
    return g, tg, labels


def adjacencies(g, form):
    args = (g.edge_index[0], g.edge_index[1], g.edge_weight, g.num_nodes)
    if form == "hybrid":
        return jops.to_hybrid(*args, block=32, bandwidth=2), tops.to_hybrid(*args, block=32,
                                                                             bandwidth=2)
    return jops.to_banded(*args, block=32, bandwidth=2), tops.to_banded(*args, block=32,
                                                                         bandwidth=2)


def partitions(form, g, tg, labels, num_shards=D, **kw):
    ja, ta = adjacencies(g, form)
    if form == "hybrid":
        return (jp.partition_hybrid(ja, g.node_features, num_shards, labels=labels, **kw),
                tp.partition_hybrid(ta, tg.node_features, num_shards, labels=labels, **kw), ja, ta)
    return (jp.partition_banded(ja, g.node_features, num_shards, labels=labels, **kw),
            tp.partition_banded(ta, tg.node_features, num_shards, labels=labels, **kw), ja, ta)


@pytest.fixture(scope="module")
def graphs():
    return {"band": spatial(41), "hybrid": spatial(41, shortcut_frac=0.15)}


@pytest.fixture(scope="module")
def meshes():
    return (jp.create_mesh(shape=(D,), axis_names=("edge",), devices=jax.devices()[:D]),
            tp.create_mesh((D,), ("edge",), device="cpu"))


# ---------------------------------------------------------------------------
# Partitions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", ["band", "hybrid"])
def test_partitions_bitwise(graphs, form):
    g, tg, labels = graphs[form]
    jpart, tpart, ja, ta = partitions(form, g, tg, labels)
    assert_partitions_equal(jpart, tpart)
    for lo, hi in ((0, 2), (1, 3), (3, 4)):
        part = partitions(form, g, tg, labels, shard_range=(lo, hi))[1]
        for f in BAND_FIELDS:
            assert torch.equal(getattr(part, f), getattr(tpart, f)[lo:hi]), (f, lo, hi)
        for f in REM_FIELDS if form == "hybrid" else ():
            assert torch.equal(getattr(part, f), getattr(tpart, f)[lo:hi]), (f, lo, hi)
    args = (g.edge_index[0], g.edge_index[1], g.edge_weight)
    if form == "hybrid":
        kw = dict(block=32, bandwidth=2, labels=labels)
        assert_partitions_equal(jp.partition_hybrid_from_coo(*args, g.node_features, 768, D, **kw),
                                tp.partition_hybrid_from_coo(*args, tg.node_features, 768, D, **kw))
        assert tp.hybrid_remainder_capacities(ta, D) == jp.hybrid_remainder_capacities(ja, D)
        with pytest.raises(ValueError, match="slot_capacity"):
            tp.partition_hybrid(ta, tg.node_features, D, slot_capacity=1)
    else:
        coo = tp.partition_banded_from_coo(*args, tg.node_features, 768, D, block=32,
                                           labels=labels, shard_range=(1, 3))
        assert_partitions_equal(
            jp.partition_banded_from_coo(*args, g.node_features, 768, D, block=32,
                                         labels=labels, shard_range=(1, 3)), coo)
        for f in BAND_FIELDS:
            assert torch.equal(getattr(coo, f), getattr(tpart, f)[1:3]), f
        with pytest.raises(ValueError, match="exceeds blocks-per-shard"):
            tp.partition_banded(ta, tg.node_features, 24)


@pytest.mark.parametrize("form", ["band", "hybrid"])
def test_block_diags_bitwise(form):
    subjects = [spatial(100 + i, shortcut_frac=0.15 if form == "hybrid" else 0.0)
                for i in range(2)]
    pairs = [adjacencies(g, form) for g, _, _ in subjects]
    if form == "hybrid":
        (jc, jv), (tc, tv) = (jops.hybrid_block_diag([p[0] for p in pairs]),
                              tops.hybrid_block_diag([p[1] for p in pairs]))
        for f in ("remainder_senders", "remainder_receivers", "remainder_weights"):
            same(getattr(jc, f), getattr(tc, f), f)
        jc, tc = jc.band, tc.band
    else:
        (jc, jv), (tc, tv) = (jops.banded_block_diag([p[0] for p in pairs]),
                              tops.banded_block_diag([p[1] for p in pairs]))
    same(jc.band, tc.band, "band")
    same(jv, tv, "valid")
    assert (jc.num_nodes, jc.bandwidth) == (tc.num_nodes, tc.bandwidth)
    other = tops.to_banded(np.array([0]), np.array([1]), np.array([1.0]), 64, block=64,
                           bandwidth=0)
    with pytest.raises(ValueError, match="uniform"):
        tops.banded_block_diag([pairs[0][1] if form == "band" else pairs[0][1].band, other])


def test_halo_exchange_matches_jax(meshes):
    """W = 2 halo blocks a side, zeros past the chain's ends."""
    mesh_j, mesh = meshes
    x = np.random.default_rng(0).standard_normal((D, 3, 4, 5)).astype(np.float32)

    @partial(jax.shard_map, mesh=mesh_j, in_specs=P("edge"), out_specs=P("edge"))
    def halo(blocks):
        return jp.halo_exchange(blocks[0], 2, "edge")[None]

    want = np.asarray(halo(jnp.asarray(x)))
    got = tp.halo_exchange(torch.from_numpy(x), 2, mesh, "edge")
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (D, 7, 4, 5) and not got[0, :2].any() and not got[-1, -2:].any()


# ---------------------------------------------------------------------------
# The sharded models and their step
# ---------------------------------------------------------------------------


def models(kind):
    jm = FAMILIES[kind][0](in_channels=5, hidden_dim=16, num_layers=2)
    params, state = jm.init(jax.random.PRNGKey(0))
    tm = FAMILIES[kind][1](5, 16, num_layers=2)
    load_jax_params(tm, numpy_tree(params), numpy_tree(state))
    return jm, params, state, tm


def assert_state_matches(model, params, state, kind):
    want = reference_state_dict_from_params(numpy_tree(params), numpy_tree(state),
                                            sage=kind == "sage")
    for name, t in model.state_dict().items():
        if name in want:
            np.testing.assert_allclose(t.numpy(), want[name], rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("form", ["band", "hybrid"])
@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_sharded_model_matches_jax_and_one_device(graphs, meshes, form, kind):
    g, tg, labels = graphs[form]
    mesh_j, mesh = meshes
    jpart, tpart, _, ta = partitions(form, g, tg, labels)
    jm, params, state, tm = models(kind)
    want = np.asarray(jm.forward(params, state, jpart, mesh_j))
    tm.eval()
    got = tm(mesh.place(tpart), mesh).detach()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    plain = FAMILIES[kind][2](5, 16, num_layers=2)
    plain.load_state_dict(tm.state_dict())
    flat = plain.eval()(ta, torch.from_numpy(tg.node_features)).detach()
    np.testing.assert_allclose(got.reshape(-1, 2)[:768].numpy(), flat.numpy(), rtol=RTOL,
                               atol=ATOL)
    # one step's gradients
    opt = optax.sgd(1.0)
    p2, s2, _, jloss, jn = jp.make_sharded_banded_train_step(jm, opt, mesh_j)(
        params, state, opt.init(params), jax.random.PRNGKey(1), jpart)
    step = tp.make_sharded_banded_train_step(tm, torch.optim.SGD(tm.parameters(), lr=1.0), mesh)
    loss, n = step(mesh.place(tpart))
    assert float(n) == float(jn) == 768.0
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert_state_matches(tm, p2, s2, kind)


@pytest.mark.parametrize("form", ["band", "hybrid"])
def test_2d_step_matches_jax_and_the_block_diagonal(form):
    """A (data 2 × edge 2) mesh over a cohort of two subjects: one SGD(lr 1)
    step against JAX's 2-D step, and against one device's BandedNodeGCN
    step on the cohort's block diagonal (loss, every gradient)."""
    frac = 0.15 if form == "hybrid" else 0.0
    subjects = [spatial(100 + i, shortcut_frac=frac) for i in range(2)]
    pairs = [adjacencies(g, form) for g, _, _ in subjects]
    feats = [tg.node_features for _, tg, _ in subjects]
    labels = [lab for _, _, lab in subjects]
    if form == "hybrid":
        js = jp.partition_hybrid_cohort([p[0] for p in pairs], feats, 2, labels=labels)
        ts = tp.partition_hybrid_cohort([p[1] for p in pairs], feats, 2, labels=labels)
        combined, valid = tops.hybrid_block_diag([p[1] for p in pairs])
    else:
        js = jp.stack_partitioned([jp.partition_banded(p[0], x, 2, labels=lab)
                                   for p, x, lab in zip(pairs, feats, labels)])
        ts = tp.stack_partitioned([tp.partition_banded(p[1], x, 2, labels=lab)
                                   for p, x, lab in zip(pairs, feats, labels)])
        combined, valid = tops.banded_block_diag([p[1] for p in pairs])
    assert_partitions_equal(js, ts)
    mesh_j = jp.create_mesh(shape=(2, 2), axis_names=("data", "edge"), devices=jax.devices()[:4])
    mesh = tp.create_mesh((2, 2), ("data", "edge"), device="cpu")
    jm, params, state, tm = models("gcn")
    oracle = BandedNodeGCN(5, 16, num_layers=2)
    oracle.load_state_dict(tm.state_dict())
    opt = optax.sgd(1.0)
    p2, s2, _, jloss, jn = jp.make_banded_train_step_2d(jm, opt, mesh_j)(
        params, state, opt.init(params), jax.random.PRNGKey(1), js)
    loss, n = tp.make_banded_train_step_2d(tm, torch.optim.SGD(tm.parameters(), lr=0.0),
                                           mesh)(mesh.place(ts))
    assert float(n) == float(jn) == 2 * 768
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    # the oracle: one device on the block diagonal
    x = torch.from_numpy(np.concatenate(feats))
    logits = oracle.train()(combined, x, node_mask=valid)
    y = torch.from_numpy(np.concatenate(labels)).long()
    want = torch.nn.functional.cross_entropy(logits, y)
    want.backward()
    np.testing.assert_allclose(float(loss), float(want.detach()), rtol=1e-5)
    grads = {}
    for (name, p), q in zip(tm.named_parameters(), oracle.parameters()):
        torch.testing.assert_close(p.grad, q.grad, rtol=RTOL, atol=ATOL, msg=name)
        grads[name] = p.grad
    # and JAX's gradients (params - p2 at lr 1)
    before = reference_state_dict_from_params(numpy_tree(params), numpy_tree(state), sage=False)
    after = reference_state_dict_from_params(numpy_tree(p2), numpy_tree(s2), sage=False)
    for name, gval in grads.items():
        np.testing.assert_allclose(gval.numpy(), before[name] - after[name], rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    with pytest.raises(ValueError, match="axes"):
        tp.make_banded_train_step_2d(tm, torch.optim.SGD(tm.parameters(), lr=1.0),
                                     tp.create_mesh((4,), ("edge",), device="cpu"))
