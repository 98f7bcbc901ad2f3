"""The ops' smaller API against the JAX package's: ``coo_spmm``'s
``edge_chunk``, ``hybrid_spmm``'s ``remainder_chunk``, ``sddmm``,
``gcn_normalize``'s ``self_loop_weight`` and ``eps``, and ``to_device``.

Inputs are made by numpy from a seed, with padding ids one past the end
as the batches carry them; results are held at rtol / atol 1e-5 (a
chunked float32 sum adds in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import connectome_gnn_tpu.ops.banded as jb
import connectome_gnn_tpu.ops.gcn_norm as jg
import connectome_gnn_tpu.ops.segment as js
import connectome_gnn_tpu_torch.data as td
import connectome_gnn_tpu_torch.ops.banded as tb
import connectome_gnn_tpu_torch.ops.gcn_norm as tg
import connectome_gnn_tpu_torch.ops.segment as ts

TOL = dict(rtol=1e-5, atol=1e-5)


def padded_coo(n, e, pad, seed):
    """Receiver-sorted random edges plus ``pad`` padded ones (id ``n``,
    weight 0)."""
    rng = np.random.default_rng(seed)
    s, r = rng.integers(0, n, e), rng.integers(0, n, e)
    order = np.argsort(r, kind="stable")
    s = np.concatenate([s[order], np.full(pad, n)]).astype(np.int32)
    r = np.concatenate([r[order], np.full(pad, n)]).astype(np.int32)
    w = np.concatenate([rng.random(e), np.zeros(pad)]).astype(np.float32)
    return s, r, w


def t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64 if a.dtype.kind == "i" else a.dtype))


@pytest.mark.parametrize("edge_chunk", [None, 64, 97, 1000, 5000])
def test_coo_spmm_edge_chunk_matches_jax(edge_chunk):
    n, F = 300, 8
    s, r, w = padded_coo(n, 1000, pad=24, seed=0)  # 1024 edges: 97 leaves a ragged last chunk
    x = np.random.default_rng(1).standard_normal((n, F)).astype(np.float32)
    want = js.coo_spmm(jnp.asarray(w), jnp.asarray(s), jnp.asarray(r), jnp.asarray(x), n,
                       edge_chunk=edge_chunk)
    got = ts.coo_spmm(t(w), t(s), t(r), torch.from_numpy(x), n, edge_chunk=edge_chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), ts.coo_spmm(t(w), t(s), t(r), torch.from_numpy(x), n).numpy(),
                               **TOL)


def test_coo_spmm_edge_chunk_backward_matches_unchunked():
    n, F = 200, 4
    s, r, w = padded_coo(n, 700, pad=12, seed=2)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((n, F)).astype(np.float32))
    grads = []
    for chunk in (None, 50):
        xx = x.clone().requires_grad_()
        ts.coo_spmm(t(w), t(s), t(r), xx, n, edge_chunk=chunk).square().sum().backward()
        grads.append(xx.grad)
    np.testing.assert_allclose(grads[1].numpy(), grads[0].numpy(), **TOL)


@pytest.mark.parametrize("remainder_chunk", [None, 32, 100])
def test_hybrid_spmm_remainder_chunk_matches_jax(remainder_chunk):
    g = td.generate_spatial_graph(1500, degree=8, band=64, seed=4, shortcut_frac=0.1)
    s, r = g.edge_index
    x = np.random.default_rng(5).standard_normal((g.num_nodes, 8)).astype(np.float32)
    jh = jb.to_hybrid(s, r, g.edge_weight, g.num_nodes, block=64, bandwidth=1)
    th = tb.to_hybrid(s, r, g.edge_weight, g.num_nodes, block=64, bandwidth=1)
    assert int(th.remainder_weights.shape[0]) > 100  # more than one chunk
    want = jb.hybrid_spmm(jh, jnp.asarray(x), remainder_chunk=remainder_chunk)
    got = tb.hybrid_spmm(th, torch.from_numpy(x), remainder_chunk=remainder_chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sddmm_matches_jax():
    n, F = 120, 16
    s, r, _ = padded_coo(n, 500, pad=12, seed=6)
    rng = np.random.default_rng(7)
    x, y = (rng.standard_normal((n, F)).astype(np.float32) for _ in range(2))
    want = js.sddmm(jnp.asarray(x), jnp.asarray(y), jnp.asarray(s), jnp.asarray(r))
    got = ts.sddmm(torch.from_numpy(x), torch.from_numpy(y), t(s), t(r))
    assert got.shape == (512,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("self_loop_weight, eps", [(1.0, 1e-8), (2.5, 1e-8), (0.0, 1e-3)])
def test_gcn_normalize_keywords_match_jax(self_loop_weight, eps):
    n = 150
    s, r, w = padded_coo(n, 600, pad=16, seed=8)
    want = jg.gcn_normalize(jnp.asarray(s), jnp.asarray(r), jnp.asarray(w), n,
                            self_loop_weight=self_loop_weight, eps=eps)
    got = tg.gcn_normalize(t(s), t(r), t(w), n, self_loop_weight=self_loop_weight, eps=eps)
    for name in ("edge_norm", "self_norm", "deg_inv_sqrt"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), **TOL,
                                   err_msg=name)


def test_gcn_normalize_defaults_are_unchanged_bitwise():
    n = 150
    s, r, w = padded_coo(n, 600, pad=16, seed=9)
    plain = tg.gcn_normalize(t(s), t(r), t(w), n)
    explicit = tg.gcn_normalize(t(s), t(r), t(w), n, self_loop_weight=1.0, eps=1e-8)
    for a, b in zip(plain, explicit):
        assert torch.equal(a, b)


@pytest.mark.parametrize("layout", ["coo", "dense"])
def test_to_device_round_trips(layout):
    graphs = td.generate_dataset(num_subjects=3, num_regions=20, seed=10)
    batch = td.collate_graphs(graphs) if layout == "coo" else td.collate_dense(graphs)
    moved = td.to_device(batch, "cpu")
    assert type(moved) is type(batch) and moved is not batch
    for name, value in vars(batch).items():
        if isinstance(value, torch.Tensor):
            assert getattr(moved, name).device.type == "cpu"
            assert torch.equal(getattr(moved, name), value)
        else:
            assert getattr(moved, name) == value


def test_to_device_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    batch = td.collate_graphs(td.generate_dataset(num_subjects=2, num_regions=10, seed=11))
    with pytest.raises(RuntimeError, match="CUDA"):
        td.to_device(batch)
