"""The port's dataset I/O (``data/io.py``) against the JAX package's.

``graph_from_adjacency`` is numpy in both packages, so every array must be
bitwise equal; a ``.npz`` written by either package loads in the other,
key for key and dtype for dtype.
"""

import numpy as np
import pytest

import connectome_gnn_tpu.data as jd
import connectome_gnn_tpu_torch.data as td

FIELDS = ("node_features", "edge_index", "edge_weight")


def adjacency(kind: str, n: int = 23, seed: int = 0) -> np.ndarray:
    """A seeded dense matrix: symmetric or not, non-negative or with
    negative weights, a nonzero diagonal and a share of exact zeros."""
    rng = np.random.default_rng(seed)
    a = rng.random((n, n)).astype(np.float32)
    if kind == "negative":
        a -= 0.5
    a[rng.random((n, n)) < 0.3] = 0.0
    if kind != "asymmetric":
        a = np.triu(a) + np.triu(a, 1).T
    return a


def assert_graphs_equal(a, b):
    for field in FIELDS:
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype, field
        np.testing.assert_array_equal(x, y, err_msg=field)
    assert a.label == b.label and a.subject_id == b.subject_id


@pytest.mark.parametrize("label", [None, 3])
@pytest.mark.parametrize("features", ["default", "given"])
@pytest.mark.parametrize("threshold", [0.0, 0.1])
@pytest.mark.parametrize("kind", ["symmetric", "asymmetric", "negative"])
def test_graph_from_adjacency_bitwise_jax(kind, threshold, features, label):
    a = adjacency(kind)
    x = (np.random.default_rng(1).standard_normal((a.shape[0], 4)).astype(np.float32)
         if features == "given" else None)
    kw = dict(node_features=x, label=label, subject_id="sub-7", threshold=threshold)
    want = jd.graph_from_adjacency(a, **kw)
    got = td.graph_from_adjacency(a, **kw)
    assert isinstance(got, td.ConnectomeGraph)
    assert_graphs_equal(got, want)
    assert got.num_edges > 0 and not (got.edge_index[0] == got.edge_index[1]).any()
    assert (np.abs(got.edge_weight) > threshold).all()


@pytest.mark.parametrize("shape", [(3, 4), (5,), (2, 2, 2)])
def test_graph_from_adjacency_refuses_a_matrix_that_is_not_square(shape):
    with pytest.raises(ValueError, match="square"):
        td.graph_from_adjacency(np.ones(shape, np.float32))


def dataset():
    """Graphs from both constructors, with and without a label."""
    graphs = td.generate_dataset(num_subjects=4, num_regions=12, seed=3)
    graphs[1].label = None
    x = np.random.default_rng(4).standard_normal((9, graphs[0].num_features)).astype(np.float32)
    graphs.append(td.graph_from_adjacency(adjacency("negative", n=9), node_features=x, label=1,
                                          subject_id="dense"))
    return graphs


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_file_written_by_either_package_loads_in_both(tmp_path, writer):
    graphs = dataset()
    path = str(tmp_path / "cohort.npz")
    (td if writer == "port" else jd).save_dataset(path, graphs)
    loaded_port, loaded_jax = td.load_dataset(path), jd.load_dataset(path)
    assert len(loaded_port) == len(loaded_jax) == len(graphs)
    for original, p, j in zip(graphs, loaded_port, loaded_jax):
        assert isinstance(p, td.ConnectomeGraph)
        assert_graphs_equal(p, original)
        assert_graphs_equal(p, j)
    assert [g.label for g in loaded_port] == [g.label for g in graphs]
    assert loaded_port[1].label is None


def test_the_file_layout_is_the_jax_packages(tmp_path):
    graphs = dataset()
    td.save_dataset(str(tmp_path / "port.npz"), graphs)
    jd.save_dataset(str(tmp_path / "jax.npz"), graphs)
    with np.load(tmp_path / "port.npz", allow_pickle=False) as p, \
            np.load(tmp_path / "jax.npz", allow_pickle=False) as j:
        assert sorted(p.files) == sorted(j.files) == sorted(
            ["node_features", "edge_index", "edge_weight", "node_ptr", "edge_ptr", "labels",
             "subject_ids"])
        for key in p.files:
            assert p[key].dtype == j[key].dtype, key
            np.testing.assert_array_equal(p[key], j[key], err_msg=key)
        assert p["labels"].dtype == np.int64 and p["labels"][1] == -1


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_path_without_npz(tmp_path, writer):
    graphs = dataset()
    path = str(tmp_path / "nested" / "cohort")
    (td if writer == "port" else jd).save_dataset(path, graphs)
    assert (tmp_path / "nested" / "cohort.npz").exists()
    for got, want in zip(td.load_dataset(path), graphs):
        assert_graphs_equal(got, want)
