"""The PyTorch port's data layer against the JAX package's, bitwise.

Synthetic graphs, atlas, both collates and the loader's batch order are
built by the same numpy code in both packages, so every array must be
equal (index dtypes differ: int64 in the port, int32 in JAX).
"""

import numpy as np
import pytest
import torch

import connectome_gnn_tpu.data as jd
import connectome_gnn_tpu_torch.data as td


@pytest.fixture(scope="module")
def graphs():
    return (
        jd.generate_dataset(num_subjects=12, num_regions=18, seed=5),
        td.generate_dataset(num_subjects=12, num_regions=18, seed=5),
    )


def assert_same(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_atlas_names_equal():
    assert td.REGION_NAMES == jd.REGION_NAMES
    assert td.NUM_REGIONS == jd.NUM_REGIONS == 83


def test_generate_dataset_bitwise(graphs):
    jg, tg = graphs
    assert len(jg) == len(tg) == 12
    for a, b in zip(jg, tg):
        assert a.subject_id == b.subject_id and a.label == b.label
        for field in ("node_features", "edge_index", "edge_weight"):
            x, y = getattr(a, field), getattr(b, field)
            assert x.dtype == y.dtype
            assert_same(x, y)


def test_generate_connectome_bitwise():
    a = jd.generate_connectome(num_regions=16, k=6, beta=0.3, trait_idx=2, seed=11)
    b = td.generate_connectome(num_regions=16, k=6, beta=0.3, trait_idx=2, seed=11)
    assert a.subject_id == b.subject_id and a.label == b.label
    assert_same(a.edge_weight, b.edge_weight)
    assert_same(a.node_features, b.node_features)


def test_small_world_stats_equal(graphs):
    jg, tg = graphs
    assert td.small_world_stats(tg) == jd.small_world_stats(jg)


@pytest.mark.parametrize("kwargs", [{}, {"num_graphs": 16, "node_budget": 24}])
def test_collate_dense_bitwise(graphs, kwargs):
    jg, tg = graphs
    a = jd.collate_dense(jg, **kwargs)
    b = td.collate_dense(tg, **kwargs)
    assert a.num_graphs == b.num_graphs
    for field in ("node_features", "adj", "node_mask", "labels", "label_mask"):
        assert_same(getattr(a, field), getattr(b, field))
    assert_same(a.graph_mask, b.graph_mask)


@pytest.mark.parametrize(
    "kwargs", [{}, {"num_graphs": 14, "node_budget": 400, "edge_budget": 4096}]
)
def test_collate_graphs_bitwise(graphs, kwargs):
    jg, tg = graphs
    a = jd.collate_graphs(jg, **kwargs)
    b = td.collate_graphs(tg, **kwargs)
    assert a.num_graphs == b.num_graphs
    for field in (
        "node_features", "senders", "receivers", "edge_weight", "node_graph_ids",
        "node_mask", "edge_mask", "labels", "label_mask", "ptr", "row_ptr",
    ):
        assert_same(getattr(a, field), getattr(b, field))
    assert_same(a.graph_mask, b.graph_mask)
    assert_same(a.edge_index, b.edge_index)


@pytest.mark.parametrize("layout", ["coo", "dense"])
def test_loader_batch_order_bitwise(graphs, layout):
    """Same shuffle stream: two epochs of shuffled batches are identical."""
    jg, tg = graphs
    jl = jd.ConnectomeDataLoader(jg, batch_size=5, shuffle=True, seed=3, layout=layout)
    tl = td.ConnectomeDataLoader(tg, batch_size=5, shuffle=True, seed=3, layout=layout)
    assert len(jl) == len(tl) == 3
    for _ in range(2):
        for a, b in zip(jl, tl, strict=True):
            assert_same(a.node_features, b.node_features)
            assert_same(a.labels, b.labels)
            assert_same(a.label_mask, b.label_mask)


def test_loader_places_batches_on_device(graphs):
    _, tg = graphs
    loader = td.ConnectomeDataLoader(
        tg, batch_size=4, shuffle=False, layout="dense", device=torch.device("cpu")
    )
    batch = next(iter(loader))
    assert batch.adj.device.type == "cpu" and batch.node_mask.dtype == torch.bool
    moved = batch.to("cpu")
    assert_same(moved.adj, batch.adj)


def test_loader_sharding_names_its_slice(graphs):
    """The graph loader shards since slice E1 (stacked batches, bitwise
    JAX's, in ``tests/test_torch_parallel.py``); its process arguments need
    ``num_shards``, as JAX's do, and the sampled loaders' sharding names
    slice E3, which is still to come."""
    jg, tg = graphs
    batch = next(iter(td.ConnectomeDataLoader(tg, batch_size=4, shuffle=False, num_shards=2)))
    want = next(iter(jd.ConnectomeDataLoader(jg, batch_size=4, shuffle=False, num_shards=2)))
    assert batch.node_features.shape[0] == 2 and batch.num_graphs == want.num_graphs == 2
    assert_same(batch.senders, want.senders)
    with pytest.raises(ValueError, match="requires num_shards"):
        td.ConnectomeDataLoader(tg, batch_size=4, process_index=0, process_count=2)
    with pytest.raises(NotImplementedError, match="slice E3"):
        td.SampledNodeLoader(td.generate_spatial_graph(64, degree=4, band=8), num_shards=2,
                             device="cpu")
