"""The port's giant-graph data and float32 band ops against the JAX package.

``generate_spatial_graph``, RCM, ``apply_ordering``, ``bandwidth``, the host
``to_banded`` and ``to_hybrid`` must be bitwise equal: both packages run the
same numpy.  Degrees and the GCN normalization agree within 1e-6, relative
and absolute (sums in another order); the float32 band SpMMs at rtol 1e-5 /
atol 1e-5, the JAX package's kernel-versus-emulation gate.  Sizes are the
JAX tests': 640 nodes (600 for the ragged tail), block 64, degree 6, band
40, F = 16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import connectome_gnn_tpu.data as jd
import connectome_gnn_tpu.ops.banded as jb
from connectome_gnn_tpu.data import reorder as jr
import connectome_gnn_tpu_torch.data as td
import connectome_gnn_tpu_torch.ops.banded as tb

RTOL, ATOL = 1e-5, 1e-5
NORM_TOL = 1e-6  # relative and absolute: degrees reach ~17, one f32 step there is 1.9e-6


def graphs(n, seed=0, shortcut_frac=0.0, F=16):
    kw = dict(degree=6, band=40, num_features=F, seed=seed, shortcut_frac=shortcut_frac)
    return jd.generate_spatial_graph(n, **kw), td.generate_spatial_graph(n, **kw)


def coo(g):
    return g.edge_index[0], g.edge_index[1], g.edge_weight


@pytest.fixture(scope="module")
def bands():
    """n → (JAX band, port band, features) for the pure band and n=600."""
    out = {}
    for n in (640, 600):
        jg, tg = graphs(n)
        out[n] = (jb.to_banded(*coo(jg), n, block=64), tb.to_banded(*coo(tg), n, block=64),
                  tg.node_features)
    return out


@pytest.fixture(scope="module")
def hybrids():
    jg, tg = graphs(640, seed=3, shortcut_frac=0.15)
    kw = dict(block=64, bandwidth=1)
    return jb.to_hybrid(*coo(jg), 640, **kw), tb.to_hybrid(*coo(tg), 640, **kw), tg.node_features


@pytest.mark.parametrize("shortcut_frac", [0.0, 0.1])
@pytest.mark.parametrize("n", [640, 600])
def test_generate_spatial_graph_is_bitwise_equal(n, shortcut_frac):
    jg, tg = graphs(n, seed=5, shortcut_frac=shortcut_frac)
    for field in ("node_features", "edge_index", "edge_weight"):
        np.testing.assert_array_equal(getattr(tg, field), getattr(jg, field))
    assert tg.subject_id == jg.subject_id and tg.label is None


def test_rcm_ordering_and_bandwidth_are_bitwise_equal():
    jg, tg = graphs(2000, seed=1)
    scramble = np.random.default_rng(0).permutation(2000)
    js, ts = jr.apply_ordering(jg, scramble), td.apply_ordering(tg, scramble)
    np.testing.assert_array_equal(ts.edge_index, js.edge_index)
    np.testing.assert_array_equal(ts.node_features, js.node_features)
    perm = td.reverse_cuthill_mckee(ts.edge_index, 2000)
    np.testing.assert_array_equal(perm, jr.reverse_cuthill_mckee(js.edge_index, 2000))
    jrec, trec = jr.apply_ordering(js, perm), td.apply_ordering(ts, perm)
    np.testing.assert_array_equal(trec.edge_index, jrec.edge_index)
    assert td.bandwidth(ts.edge_index) == jr.bandwidth(js.edge_index)
    assert td.bandwidth(trec.edge_index) == jr.bandwidth(jrec.edge_index)
    assert td.bandwidth(trec.edge_index) < td.bandwidth(ts.edge_index) // 4
    assert td.bandwidth(np.zeros((2, 0), np.int32)) == 0


def test_rcm_handles_isolated_nodes_and_components():
    edge_index = np.array([[0, 1, 4, 5], [1, 0, 5, 4]], np.int32)  # nodes 2, 3, 6 isolated
    perm = td.reverse_cuthill_mckee(edge_index, 7)
    np.testing.assert_array_equal(perm, jr.reverse_cuthill_mckee(edge_index, 7))
    assert sorted(perm.tolist()) == list(range(7))


@pytest.mark.parametrize("n", [640, 600])
def test_to_banded_host_build_is_bitwise_equal(bands, n):
    ja, ta, _ = bands[n]
    assert (ta.num_nodes, ta.bandwidth, ta.block, ta.num_blocks) == (
        ja.num_nodes, ja.bandwidth, ja.block, ja.num_blocks)
    assert ta.band.dtype == torch.float32
    np.testing.assert_array_equal(ta.band.numpy(), np.asarray(ja.band))


def test_to_banded_device_build_matches_the_host_build():
    _, tg = graphs(600)
    host = tb.to_banded(*coo(tg), 600, block=64)
    scattered = tb.to_banded(*coo(tg), 600, block=64, device="cpu")
    assert scattered.bandwidth == host.bandwidth
    np.testing.assert_allclose(scattered.band.numpy(), host.band.numpy(), rtol=NORM_TOL, atol=NORM_TOL)


def test_to_banded_rejects_edges_outside_an_explicit_band():
    jg, tg = graphs(640)
    with pytest.raises(ValueError, match="outside band"):
        jb.to_banded(*coo(jg), 640, block=64, bandwidth=0)
    with pytest.raises(ValueError, match="outside band"):
        tb.to_banded(*coo(tg), 640, block=64, bandwidth=0)
    with pytest.raises(ValueError, match="outside band"):
        tb.to_banded(*coo(tg), 640, block=64, bandwidth=0, device="cpu")


def test_to_hybrid_arrays_are_bitwise_equal(hybrids):
    jh, th, _ = hybrids
    np.testing.assert_array_equal(th.band.band.numpy(), np.asarray(jh.band.band))
    for field in ("remainder_senders", "remainder_receivers", "remainder_weights"):
        np.testing.assert_array_equal(getattr(th, field).numpy(), np.asarray(getattr(jh, field)))
    assert th.remainder_senders.dtype == torch.int64
    assert int((th.remainder_weights > 0).sum()) > 0


@pytest.mark.parametrize("n", [640, 600])
def test_degrees_and_row_sums(bands, n):
    ja, ta, _ = bands[n]
    np.testing.assert_allclose(tb.banded_row_sum(ta).numpy(), np.asarray(jb.banded_row_sum(ja)),
                               rtol=NORM_TOL, atol=NORM_TOL)
    np.testing.assert_allclose(tb.banded_sender_degree(ta).numpy(),
                               np.asarray(jb.banded_sender_degree(ja)), rtol=NORM_TOL, atol=NORM_TOL)


def test_hybrid_degrees_and_row_sums(hybrids):
    jh, th, _ = hybrids
    np.testing.assert_allclose(tb.hybrid_row_sum(th).numpy(), np.asarray(jb.hybrid_row_sum(jh)),
                               rtol=NORM_TOL, atol=NORM_TOL)
    np.testing.assert_allclose(tb.hybrid_sender_degree(th).numpy(),
                               np.asarray(jb.hybrid_sender_degree(jh)), rtol=NORM_TOL, atol=NORM_TOL)


@pytest.mark.parametrize("n", [640, 600])
def test_gcn_normalize_banded(bands, n):
    ja, ta, _ = bands[n]
    (jn, jdinv), (tn, tdinv) = jb.gcn_normalize_banded(ja), tb.gcn_normalize_banded(ta)
    np.testing.assert_allclose(tn.band.numpy(), np.asarray(jn.band), rtol=NORM_TOL, atol=NORM_TOL)
    np.testing.assert_allclose(tdinv.numpy(), np.asarray(jdinv), rtol=NORM_TOL, atol=NORM_TOL)


def test_gcn_normalize_hybrid(hybrids):
    jh, th, _ = hybrids
    (jn, jdinv), (tn, tdinv) = jb.gcn_normalize_hybrid(jh), tb.gcn_normalize_hybrid(th)
    np.testing.assert_allclose(tn.band.band.numpy(), np.asarray(jn.band.band), rtol=NORM_TOL, atol=NORM_TOL)
    np.testing.assert_allclose(tn.remainder_weights.numpy(), np.asarray(jn.remainder_weights),
                               rtol=NORM_TOL, atol=NORM_TOL)
    np.testing.assert_allclose(tdinv.numpy(), np.asarray(jdinv), rtol=NORM_TOL, atol=NORM_TOL)


@pytest.mark.parametrize("n", [640, 600])
def test_banded_spmm(bands, n):
    ja, ta, x = bands[n]
    got = tb.banded_spmm(ta, torch.from_numpy(x)).numpy()
    assert got.shape == (n, 16)
    np.testing.assert_allclose(got, np.asarray(jb.banded_spmm(ja, jnp.asarray(x))), rtol=RTOL, atol=ATOL)


def test_banded_spmm_on_a_bfloat16_band(bands):
    ja, ta, x = bands[640]
    jbf = ja._replace(band=ja.band.astype(jnp.bfloat16))
    tbf = ta._replace(band=ta.band.to(torch.bfloat16))
    got = tb.banded_spmm(tbf, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jb.banded_spmm(jbf, jnp.asarray(x))), rtol=RTOL, atol=ATOL)


def test_hybrid_spmm(hybrids):
    jh, th, x = hybrids
    got = tb.hybrid_spmm(th, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jb.hybrid_spmm(jh, jnp.asarray(x))), rtol=RTOL, atol=ATOL)
