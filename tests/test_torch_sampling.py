"""The port's host sampler, its collate and ``SampledNodeLoader`` against the
JAX package's, bitwise.

``sample_subgraph`` is numpy and takes a numpy generator; ``NeighborSampler``
and the fused collate run the native helpers, which both packages build
from the same C++ source, so for the same seeds every array is bitwise
equal: the subgraphs and node ids, ``collate_sampled``'s and
``full_graph_batch``'s batches, and ``SampledNodeLoader``'s batches over two
epochs, fused (the native collate, the feature gather on the device) and
classic (``NeighborSampler.sample`` + ``collate_sampled``).  The graph is
``generate_spatial_graph(4096, degree=8, band=64, shortcut_frac=0.1)``,
64 seeds a batch, fanout (4, 3).
"""

import dataclasses

import numpy as np
import pytest
import torch

import connectome_gnn_tpu.data as jd
import connectome_gnn_tpu.data.sampled as jsampled
import connectome_gnn_tpu.data.sampling as jsampling
import connectome_gnn_tpu.native as jnative
import connectome_gnn_tpu_torch.data as td
import connectome_gnn_tpu_torch.data.sampled as tsampled
import connectome_gnn_tpu_torch.data.sampling as tsampling
import connectome_gnn_tpu_torch.native as tnative

N, FANOUT, BATCH = 4096, (4, 3), 64
FIELDS = ("node_features", "senders", "receivers", "edge_weight", "node_mask", "labels",
          "label_mask", "seed_mask", "node_ids")


@pytest.fixture(scope="module")
def graphs():
    """The same spatial graph built by each package, and node labels."""
    kw = dict(degree=8, band=64, shortcut_frac=0.1, seed=0)
    jg, tg = jd.generate_spatial_graph(N, **kw), td.generate_spatial_graph(N, **kw)
    labels = np.random.default_rng(1).integers(0, 3, N).astype(np.int32)
    return jg, tg, labels


def assert_same_graph(t, j):
    np.testing.assert_array_equal(t.node_features, j.node_features)
    np.testing.assert_array_equal(t.edge_index, j.edge_index)
    np.testing.assert_array_equal(t.edge_weight, j.edge_weight)
    assert (t.label, t.subject_id) == (j.label, j.subject_id)


def assert_same_batch(t, j):
    """Every array of a port batch bitwise equal to the JAX batch's."""
    assert t.num_seeds == j.num_seeds
    for name in FIELDS:
        got, want = getattr(t, name), np.asarray(getattr(j, name))
        assert got.device.type == "cpu", name
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def seeds_of(k, seed=2):
    return np.random.default_rng(seed).choice(N, k, replace=False)


def test_sample_subgraph_is_jax(graphs):
    jg, tg, _ = graphs
    seeds = seeds_of(40)
    tsub, tids = tsampling.sample_subgraph(tg, seeds, FANOUT, np.random.default_rng(5))
    jsub, jids = jsampling.sample_subgraph(jg, seeds, FANOUT, np.random.default_rng(5))
    np.testing.assert_array_equal(tids, jids)
    assert_same_graph(tsub, jsub)
    assert tids[:40].tolist() == seeds.tolist()


@pytest.mark.parametrize("native", [True, False])
def test_neighbor_sampler_sample_is_jax(graphs, monkeypatch, native):
    """The native splitmix64 traversal, and the numpy path both packages
    take without the native library."""
    jg, tg, _ = graphs
    if native:
        assert tnative.AVAILABLE and jnative.AVAILABLE
    else:
        monkeypatch.setattr(tnative, "AVAILABLE", False)
        monkeypatch.setattr(jnative, "AVAILABLE", False)
    seeds = seeds_of(50)
    tsub, tids = tsampling.NeighborSampler(tg).sample(seeds, FANOUT, seed=7)
    jsub, jids = jsampling.NeighborSampler(jg).sample(seeds, FANOUT, seed=7)
    np.testing.assert_array_equal(tids, jids)
    assert_same_graph(tsub, jsub)
    fsub, fids = tsampling.sample_subgraph_fast(tg, seeds, FANOUT, seed=7)
    np.testing.assert_array_equal(fids, jids)
    assert_same_graph(fsub, jsub)


def test_sample_collate_into_is_jax(graphs):
    jg, tg, _ = graphs
    nb, eb = tsampled.fanout_budgets(BATCH, FANOUT)
    out = {}
    for name, sampler in (("port", tsampling.NeighborSampler(tg)),
                          ("jax", jsampling.NeighborSampler(jg))):
        bufs = dict(out_senders=np.empty(eb, np.int32), out_receivers=np.empty(eb, np.int32),
                    out_weights=np.empty(eb, np.float32), out_node_ids=np.empty(nb, np.int32))
        counts = sampler.sample_collate_into(seeds_of(BATCH), FANOUT, 11, node_budget=nb,
                                             edge_budget=eb, **bufs)
        out[name] = counts, bufs
    assert out["port"][0] == out["jax"][0]
    for key, got in out["port"][1].items():
        np.testing.assert_array_equal(got, out["jax"][1][key], err_msg=key)


def test_sample_errors_are_jax(graphs):
    _, tg, _ = graphs
    with pytest.raises(ValueError, match="out of range"):
        tsampling.sample_subgraph(tg, [N], FANOUT)
    with pytest.raises(ValueError, match="out of range"):
        tsampling.NeighborSampler(tg).sample([-1], FANOUT)


@pytest.mark.parametrize("labelled", [True, False])
def test_collate_sampled_is_jax(graphs, labelled):
    jg, tg, labels = graphs
    seeds = seeds_of(30)
    sub, ids = tsampling.NeighborSampler(tg).sample(seeds, FANOUT, seed=3)
    nb, eb = tsampled.fanout_budgets(BATCH, FANOUT)
    kw = dict(num_seeds=BATCH, real_seeds=30, node_budget=nb, edge_budget=eb)
    seed_labels = labels[seeds] if labelled else None
    assert_same_batch(tsampled.collate_sampled(sub, ids, seed_labels, device="cpu", **kw),
                      jsampled.collate_sampled(sub, ids, seed_labels, **kw))
    with pytest.raises(ValueError, match="node_budget"):
        tsampled.collate_sampled(sub, ids, None, **{**kw, "node_budget": 8}, device="cpu")


@pytest.mark.parametrize("seed_nodes", [None, "subset"])
def test_full_graph_batch_is_jax(graphs, seed_nodes):
    jg, tg, labels = graphs
    seeds = None if seed_nodes is None else seeds_of(500, seed=9)
    assert_same_batch(td.full_graph_batch(tg, labels, seed_nodes=seeds, device="cpu"),
                      jd.full_graph_batch(jg, labels, seed_nodes=seeds))


def test_budgets_and_seeds_are_jax():
    for args in ((64, (4, 3)), (1024, (10, 10)), (7, ())):
        assert tsampled.fanout_budgets(*args) == jsampled.fanout_budgets(*args)
    assert tsampled.fanout_budgets(1024, (10, 10)) == (113_664, 112_640)
    for args in ((0, 0, 0), (5, 3, 17), (2**31 - 1, 9, 2, 3)):
        assert tsampled._sample_seed(*args) == jsampled._sample_seed(*args)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("case", ["shuffled", "unlabelled-tail"])
def test_loader_batches_are_jax(graphs, fused, case):
    """Two epochs of batches, bitwise; ``unlabelled-tail`` takes a pool of
    300 seeds unshuffled, unlabelled, with its partial last batch."""
    jg, tg, labels = graphs
    kw = dict(batch_size=BATCH, fanout=FANOUT, seed=4, fused=fused)
    if case == "shuffled":
        kw.update(node_labels=labels, seed_nodes=seeds_of(256, seed=6))
    else:
        kw.update(seed_nodes=np.arange(300) * 13, shuffle=False)
    port = tsampled.SampledNodeLoader(tg, device="cpu", **kw)
    ref = jsampled.SampledNodeLoader(jg, **kw)
    assert (len(port), port.node_budget, port.edge_budget) == (len(ref), ref.node_budget,
                                                               ref.edge_budget)
    for epoch in range(2):
        got, want = list(port), list(ref)
        assert len(got) == len(want) == len(port)
        for t, j in zip(got, want):
            assert_same_batch(t, j)
    port.set_epoch(1)
    ref.set_epoch(1)
    assert_same_batch(next(iter(port)), next(iter(ref)))


def test_loader_moves_batches_and_refuses_what_it_cannot_run(graphs, monkeypatch):
    _, tg, labels = graphs
    loader = tsampled.SampledNodeLoader(tg, labels, batch_size=BATCH, fanout=FANOUT, device="cpu")
    batch = next(iter(loader))
    assert torch.equal(batch.graph_mask, batch.seed_mask)
    blocked = dataclasses.replace(batch, hop_blocks=(td.HopBlock(
        batch.senders[:8].view(4, 2), batch.edge_weight[:8].view(4, 2), batch.receivers[:4]),))
    assert blocked.to("cpu").hop_blocks[0].senders.shape == (4, 2)
    assert tsampled.SampledNodeLoader(tg, labels, device="cpu", num_shards=2).num_shards == 2
    with pytest.raises(ValueError, match="requires num_shards"):
        tsampled.SampledNodeLoader(tg, labels, device="cpu", process_index=0, process_count=1)
    monkeypatch.setattr(tnative, "AVAILABLE", False)
    assert not tsampled.SampledNodeLoader(tg, device="cpu").fused
    with pytest.raises(RuntimeError, match="native"):
        tsampled.SampledNodeLoader(tg, fused=True, device="cpu")
