"""The port's native host helpers (``connectome_gnn_tpu_torch/native``)
against the JAX package's, and their callers against the numpy paths.

The contract is bitwise: the port builds its own copy of
``cgt_native.cpp`` (byte for byte the JAX package's), every wrapper must
return exactly what the JAX package's wrapper returns and what the numpy
form returns, and ``reverse_cuthill_mckee``, ``to_banded``'s host build and
``collate_dense`` must give the same bits with the native path forced off.
The tests need ``g++``, as ``tests/test_native.py`` does, and fail (not
skip) without it in either package.
"""

import filecmp
import os

import numpy as np
import pytest

import connectome_gnn_tpu.native as jn
import connectome_gnn_tpu_torch.data as td
import connectome_gnn_tpu_torch.native as tn
from connectome_gnn_tpu.data import sampling as jsampling
from connectome_gnn_tpu.data.reorder import reverse_cuthill_mckee as jax_rcm
from connectome_gnn_tpu_torch.data import reorder as treorder
from connectome_gnn_tpu_torch.ops import banded as tbanded


def random_coo(n, e, seed):
    """Random edges with forced duplicates, so accumulation order matters."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    src[: e // 10], dst[: e // 10] = src[0], dst[0]
    return src, dst, rng.random(e, np.float32)


def test_the_source_is_the_jax_packages_byte_for_byte():
    here = os.path.dirname(tn.__file__)
    assert filecmp.cmp(os.path.join(here, "cgt_native.cpp"),
                       os.path.join(os.path.dirname(jn.__file__), "cgt_native.cpp"), shallow=False)


def test_built_on_first_use_into_the_build_directory():
    assert jn.AVAILABLE and tn.AVAILABLE, "g++ must build both libraries"
    path = tn.library_path()
    assert os.path.dirname(path) == tn.BUILD_DIR and os.path.exists(path)
    assert os.path.basename(path).startswith("cgt_native_") and path.endswith(".so")


def csr(edge_index, n):
    src = np.concatenate([edge_index[0], edge_index[1]]).astype(np.int64)
    dst = np.concatenate([edge_index[1], edge_index[0]]).astype(np.int64)
    order = np.argsort(dst, kind="stable")
    starts = np.searchsorted(dst[order], np.arange(n))
    ends = np.searchsorted(dst[order], np.arange(n), side="right")
    return src[order], starts, ends


@pytest.mark.parametrize("case", ["random", "disconnected"])
def test_rcm_equals_jax_and_the_numpy_bfs(case):
    if case == "random":
        n = 500
        edge_index = np.stack(random_coo(n, 3000, seed=0)[:2])
    else:
        n = 20
        edge_index = np.array([[0, 1, 2, 10, 11], [1, 2, 0, 11, 12]])
    src_sorted, starts, ends = csr(edge_index, n)
    indptr = np.concatenate([starts, [src_sorted.shape[0]]]).astype(np.int64)
    degree = (ends - starts).astype(np.int64)
    got = tn.rcm(indptr, src_sorted, degree)
    np.testing.assert_array_equal(got, jn.rcm(indptr, src_sorted, degree))
    np.testing.assert_array_equal(got, treorder._rcm_numpy(n, src_sorted, starts, ends, ends - starts))
    np.testing.assert_array_equal(treorder.reverse_cuthill_mckee(edge_index, n), got)
    np.testing.assert_array_equal(jax_rcm(edge_index, n), got)


def test_band_pack_and_range_equal_jax_and_add_at():
    n, block, W = 1000, 64, 3
    src, dst, w = random_coo(n, 20000, seed=1)
    keep = np.abs(src // block - dst // block) <= W
    src, dst, w = src[keep], dst[keep], w[keep]
    nb = -(-n // block)
    shape = (nb, 2 * W + 1, block, block)
    want = np.zeros(shape, np.float32)
    np.add.at(want, (dst // block, src // block - dst // block + W, dst % block, src % block), w)
    got, jax_band = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    tn.band_pack(src, dst, w, got, W)
    jn.band_pack(src, dst, w, jax_band, W)
    assert got.tobytes() == want.tobytes() == jax_band.tobytes()
    lo, rows = 5, 6
    slab, jax_slab = np.zeros((rows,) + shape[1:], np.float32), np.zeros((rows,) + shape[1:], np.float32)
    tn.band_pack_range(src, dst, w, slab, W, lo)
    jn.band_pack_range(src, dst, w, jax_slab, W, lo)
    assert slab.tobytes() == want[lo : lo + rows].tobytes() == jax_slab.tobytes()


def test_dense_pack_equals_jax_and_add_at():
    n = 64
    src, dst, w = random_coo(n, 2000, seed=2)
    want = np.zeros((n, n), np.float32)
    np.add.at(want, (dst, src), w)
    got, jax_adj = np.zeros((n, n), np.float32), np.zeros((n, n), np.float32)
    tn.dense_pack(src, dst, w, got)
    jn.dense_pack(src, dst, w, jax_adj)
    assert got.tobytes() == want.tobytes() == jax_adj.tobytes()


def test_samplers_equal_jax():
    g = td.generate_spatial_graph(3000, degree=8, band=64, seed=3)
    order, starts, ends = jsampling._in_edge_index(g)
    src = g.edge_index[0].astype(np.int64)
    seeds, fanout = np.array([5, 900, 2999, 17], np.int64), np.array([4, 3], np.int64)
    args = (order, starts, ends, src, g.num_nodes, g.num_edges, seeds, fanout, 11)
    nodes, kept = tn.sample_subgraph(*args)
    jnodes, jkept = jn.sample_subgraph(*args)
    np.testing.assert_array_equal(nodes, jnodes)
    np.testing.assert_array_equal(kept, jkept)
    assert nodes[: len(seeds)].tolist() == seeds.tolist()
    with pytest.raises(ValueError, match="seed node out of range"):
        tn.sample_subgraph(order, starts, ends, src, g.num_nodes, g.num_edges,
                           np.array([g.num_nodes]), fanout, 11)

    weights = np.ascontiguousarray(g.edge_weight, np.float32)
    outs = []
    for lib in (tn, jn):
        handle = lib.sampler_new(g.num_nodes)
        try:
            bufs = (np.empty(256, np.int32), np.empty(256, np.int32), np.empty(256, np.float32),
                    np.empty(64, np.int32))
            counts = lib.sampler_sample_collate(handle, order, starts, ends, src, weights, seeds,
                                                fanout, 11, 64, 256, *bufs)
            outs.append((counts, [b.copy() for b in bufs]))
            with pytest.raises(ValueError, match="edge_budget"):
                lib.sampler_sample_collate(handle, order, starts, ends, src, weights, seeds, fanout,
                                           11, 64, 4, *bufs)
        finally:
            lib.sampler_free(handle)
    (counts, bufs), (jcounts, jbufs) = outs
    assert counts == jcounts == (len(nodes), len(kept))
    for a, b in zip(bufs, jbufs):
        assert a.tobytes() == b.tobytes()


def test_rcm_with_native_off_is_unchanged(monkeypatch):
    edge_index = np.stack(random_coo(400, 2500, seed=4)[:2])
    native = treorder.reverse_cuthill_mckee(edge_index, 400)
    monkeypatch.setattr(tn, "AVAILABLE", False)
    np.testing.assert_array_equal(treorder.reverse_cuthill_mckee(edge_index, 400), native)


def test_to_banded_host_build_with_native_off_is_unchanged(monkeypatch):
    g = td.generate_spatial_graph(2000, degree=8, band=96, seed=5)
    s, r = g.edge_index
    native = tbanded.to_banded(s, r, g.edge_weight, g.num_nodes, block=64).band.numpy()
    monkeypatch.setattr(tn, "AVAILABLE", False)
    plain = tbanded.to_banded(s, r, g.edge_weight, g.num_nodes, block=64).band.numpy()
    assert native.tobytes() == plain.tobytes()


def test_collate_dense_with_native_off_is_unchanged(monkeypatch):
    graphs = td.generate_dataset(num_subjects=5, num_regions=30, seed=6)
    graphs[0].edge_index[:, :40] = graphs[0].edge_index[:, :1]  # duplicate edges
    native = td.collate_dense(graphs).adj.numpy()
    monkeypatch.setattr(tn, "AVAILABLE", False)
    assert td.collate_dense(graphs).adj.numpy().tobytes() == native.tobytes()
