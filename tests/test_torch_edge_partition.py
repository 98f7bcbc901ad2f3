"""The port's edge-partitioned giant-graph mode against the JAX package
and against its own unsharded COO node models, on the CPU.

The partition is bitwise JAX's (index dtypes aside), a process's
``shard_range`` a slice of it.  At D = 4 shards on one 200-node connectome
(``tests/test_edge_partition.py:19``), with JAX's weights carried over:
logits at rtol 1e-4 / atol 1e-5 against JAX's and against the port's
``NodeGCN`` / ``NodeSAGE`` on the whole graph, and one step's gradients
(an SGD step at lr 1) at the same gate against JAX's step.
"""

import jax
import numpy as np
import optax
import pytest
import torch

import connectome_gnn_tpu.data as jd
import connectome_gnn_tpu.parallel as jp

import connectome_gnn_tpu_torch.data as td
import connectome_gnn_tpu_torch.parallel as tp
from connectome_gnn_tpu_torch.models import NodeGCN, NodeSAGE
from connectome_gnn_tpu_torch.models.compat import (
    load_jax_params,
    reference_state_dict_from_params,
)

D = 4
RTOL, ATOL = 1e-4, 1e-5
FIELDS = ("node_features", "src_slot", "receivers", "edge_weight", "send_idx", "node_mask",
          "labels", "label_mask")
FAMILIES = {"gcn": (jp.EdgePartitionedGCN, tp.EdgePartitionedGCN, NodeGCN),
            "sage": (jp.EdgePartitionedSAGE, tp.EdgePartitionedSAGE, NodeSAGE)}


@pytest.fixture(scope="module")
def giant():
    labels = (np.arange(200) % 3 == 0).astype(np.int32)
    jg = jd.generate_connectome(num_regions=200, k=10, seed=3)
    tg = td.generate_connectome(num_regions=200, k=10, seed=3)
    return jg, tg, labels


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_partitions_equal(jpart, tpart):
    assert jpart.num_shards == tpart.num_shards
    for f in FIELDS:
        a, b = np.asarray(getattr(jpart, f)), getattr(tpart, f).numpy()
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=f)


@pytest.mark.parametrize("num_shards", [4, 8])
def test_partition_graph_bitwise(giant, num_shards):
    jg, tg, labels = giant
    jpart = jp.partition_graph(jg, num_shards, node_labels=labels)
    tpart = tp.partition_graph(tg, num_shards, node_labels=labels)
    assert_partitions_equal(jpart, tpart)
    assert tpart.borrowed_rows > 0 and tpart.total_nodes >= 200
    for lo, hi in ((0, 2), (1, 3), (num_shards - 1, num_shards)):
        part = tp.partition_graph(tg, num_shards, node_labels=labels, shard_range=(lo, hi))
        for f in FIELDS:
            assert torch.equal(getattr(part, f), getattr(tpart, f)[lo:hi]), (f, lo, hi)
    with pytest.raises(ValueError, match="shard_range"):
        tp.partition_graph(tg, num_shards, shard_range=(2, 2))


@pytest.fixture(scope="module")
def meshes():
    return (jp.create_mesh(shape=(D,), axis_names=("edge",), devices=jax.devices()[:D]),
            tp.create_mesh((D,), ("edge",), device="cpu"))


def models(kind):
    jm = FAMILIES[kind][0](in_channels=5, hidden_dim=16, num_layers=2)
    params, state = jm.init(jax.random.PRNGKey(0))
    tm = FAMILIES[kind][1](5, 16, num_layers=2)
    load_jax_params(tm, numpy_tree(params), numpy_tree(state))
    return jm, params, state, tm


@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_forward_matches_jax_and_the_unsharded_model(giant, meshes, kind):
    jg, tg, labels = giant
    mesh_j, mesh = meshes
    jm, params, state, tm = models(kind)
    jpart = jp.partition_graph(jg, D, node_labels=labels)
    tpart = mesh.place(tp.partition_graph(tg, D, node_labels=labels))
    want = np.asarray(jm.forward(params, state, jpart, mesh_j))
    tm.eval()
    got = tm(tpart, mesh)
    assert got.shape == (D, tpart.nodes_per_shard, 2)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)
    # the COO node model over the whole graph, same weights
    plain = FAMILIES[kind][2](5, 16, num_layers=2)
    plain.load_state_dict(tm.state_dict())
    flat = plain.eval()(td.full_graph_batch(tg, device="cpu"))
    np.testing.assert_allclose(got.reshape(-1, 2)[:200].detach().numpy(), flat.detach().numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_train_step_gradients_match_jax(giant, meshes, kind):
    """One SGD(lr 1) step: the parameters after it are the gradients' sums;
    the loss, the count and the BatchNorm moments too."""
    jg, tg, labels = giant
    mesh_j, mesh = meshes
    jm, params, state, tm = models(kind)
    opt = optax.sgd(1.0)
    p2, s2, _, jloss, jn = jp.make_partitioned_train_step(jm, opt, mesh_j)(
        params, state, opt.init(params), jax.random.PRNGKey(1),
        jp.partition_graph(jg, D, node_labels=labels))
    step = tp.make_partitioned_train_step(tm, torch.optim.SGD(tm.parameters(), lr=1.0), mesh)
    loss, n = step(mesh.place(tp.partition_graph(tg, D, node_labels=labels)))
    assert float(n) == float(jn) == float(labels.size)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = reference_state_dict_from_params(numpy_tree(p2), numpy_tree(s2), sage=kind == "sage")
    for name, t in tm.state_dict().items():
        if name in want:
            np.testing.assert_allclose(t.numpy(), want[name], rtol=RTOL, atol=ATOL, err_msg=name)
    with pytest.raises(ValueError, match="axes"):
        tp.make_partitioned_train_step(tm, torch.optim.SGD(tm.parameters(), lr=1.0),
                                       tp.create_mesh((2, 2), ("data", "edge"), device="cpu"))


def test_the_mesh_must_fit_the_partition(giant, meshes):
    _, tg, _ = giant
    _, mesh = meshes
    tm = tp.EdgePartitionedGCN(5, 8, num_layers=1)
    with pytest.raises(ValueError, match="partitioned into 8"):
        tm(tp.partition_graph(tg, 8), mesh)
    with pytest.raises(ValueError, match="local stack holds 2"):
        tm(tp.partition_graph(tg, D, shard_range=(0, 2)), mesh)
