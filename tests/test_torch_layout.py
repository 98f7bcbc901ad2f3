"""The port's layout pipeline (``data/layout.py``) and spectral ordering
(``data/reorder.py``) against the JAX package's.

Both are host numpy and scipy code, so the contract is exact: the
spectral permutations bitwise at ``tests/test_layout.py``'s shapes, and
``plan_layout`` / ``auto_layout`` the same plan (format, ``perm`` bitwise,
W, ``remainder_frac`` and ``est_us``) when the JAX package's cost-model
constants (600 GB/s, 13 ns an edge) are passed to both.  The port's own
defaults are the card's rates and rank differently by design.  The built
layout must match the COO oracle through the permutation at
``tests/test_layout.py``'s 2e-5.
"""

import numpy as np
import pytest
import torch

import connectome_gnn_tpu.data.layout as jl
import connectome_gnn_tpu.data.reorder as jr
import connectome_gnn_tpu_torch.data as td
import connectome_gnn_tpu_torch.data.layout as tl
import connectome_gnn_tpu_torch.data.reorder as tr
from connectome_gnn_tpu_torch.ops.banded import BandedMatrix, HybridMatrix, banded_spmm, hybrid_spmm
from connectome_gnn_tpu_torch.ops.segment import coo_spmm

#: the JAX package's defaults (``connectome_gnn_tpu/data/layout.py:130-131``)
JAX_RATES = dict(hbm_gbps=600.0, scatter_ns_per_edge=13.0)


def scrambled(num_nodes, *, band, seed, shortcut_frac=0.0, scramble=7):
    """``generate_spatial_graph`` relabelled by a random permutation, as
    ``tests/test_layout.py`` scrambles it."""
    g = td.generate_spatial_graph(num_nodes, degree=8, band=band, seed=seed,
                                  shortcut_frac=shortcut_frac)
    return td.apply_ordering(g, np.random.default_rng(scramble).permutation(num_nodes))


def assert_same_plan(got, want):
    assert got.format == want.format
    np.testing.assert_array_equal(got.perm, want.perm)
    assert (got.reordered, got.block, got.bandwidth, got.remainder_frac) == (
        want.reordered, want.block, want.bandwidth, want.remainder_frac)
    assert (got.bandwidth_before, got.bandwidth_after) == (want.bandwidth_before, want.bandwidth_after)
    assert got.est_us == want.est_us


def test_spectral_iterates_equal_jax_on_a_small_world():
    gs = scrambled(8192, band=256, seed=9, shortcut_frac=0.1)
    ei = np.stack(gs.edge_index)
    for solver in ("relax", "lobpcg"):
        got = tr.spectral_ordering(ei, gs.num_nodes, gs.edge_weight, return_iterates=True, solver=solver)
        want = jr.spectral_ordering(ei, gs.num_nodes, gs.edge_weight, return_iterates=True, solver=solver)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tr.spectral_ordering(ei, gs.num_nodes, gs.edge_weight),
                                  jr.spectral_ordering(ei, gs.num_nodes, gs.edge_weight))


def test_spectral_keeps_components_contiguous_as_jax_does():
    ring = np.arange(64)
    ei = np.stack([np.concatenate([ring, ring + 64]),
                   np.concatenate([(ring + 1) % 64, (ring + 1) % 64 + 64])])
    perm = tr.spectral_ordering(ei, 128)
    np.testing.assert_array_equal(perm, jr.spectral_ordering(ei, 128))
    assert set(perm[:64]) in (set(range(64)), set(range(64, 128)))


CASES = {
    # name: (graph, plan_layout keywords)
    "scrambled band": (lambda: scrambled(4096, band=128, seed=0), dict(block=128)),
    "small world": (lambda: scrambled(4096, band=128, seed=1, shortcut_frac=0.1), dict(block=128)),
    "band budget": (lambda: scrambled(4096, band=128, seed=0), dict(block=128, max_band_gb=1e-6)),
    "quantized": (lambda: scrambled(4096, band=128, seed=2, shortcut_frac=0.05),
                  dict(block=128, quantized=True)),
    "already ordered": (lambda: td.generate_spatial_graph(2048, degree=8, band=128, seed=4),
                        dict(block=128)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plan_equals_jax_at_jax_rates(case):
    make, kw = CASES[case]
    g = make()
    s, r = g.edge_index
    got = tl.plan_layout(s, r, g.num_nodes, weights=g.edge_weight, **kw, **JAX_RATES)
    want = jl.plan_layout(s, r, g.num_nodes, weights=g.edge_weight, **kw, **JAX_RATES)
    assert_same_plan(got, want)
    expected = {"scrambled band": ("banded", "hybrid"), "small world": ("hybrid",),
                "band budget": ("coo",), "quantized": ("banded", "hybrid"),
                "already ordered": ("banded", "hybrid")}[case]
    assert got.format in expected


def test_uniform_random_graph_plans_coo_as_jax_does():
    rng = np.random.default_rng(3)
    n, e = 32768, 131072
    s, r = rng.integers(0, n, e), rng.integers(0, n, e)
    got = tl.plan_layout(s, r, n, block=128, **JAX_RATES)
    assert_same_plan(got, jl.plan_layout(s, r, n, block=128, **JAX_RATES))
    assert got.format == "coo" and not got.reordered and got.remainder_frac == 1.0


def test_the_defaults_are_the_cards_not_the_tpus():
    import inspect

    defaults = inspect.signature(tl.plan_layout).parameters
    assert defaults["hbm_gbps"].default == tl.HBM_GBPS > 0
    assert defaults["scatter_ns_per_edge"].default == tl.SCATTER_NS_PER_EDGE > 0
    assert (tl.HBM_GBPS, tl.SCATTER_NS_PER_EDGE) != (600.0, 13.0)


def spmm_any(adj, x, num_nodes):
    if isinstance(adj, BandedMatrix):
        return banded_spmm(adj, x)
    if isinstance(adj, HybridMatrix):
        return hybrid_spmm(adj, x)
    s, r, w = adj
    return coo_spmm(w, s, r, x, num_nodes)


@pytest.mark.parametrize("shortcut_frac", [0.0, 0.1])
def test_auto_layout_matches_the_coo_oracle_through_perm(shortcut_frac):
    gs = scrambled(2048, band=128, seed=5, shortcut_frac=shortcut_frac)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((gs.num_nodes, 16)).astype(np.float32))
    s, r = (torch.from_numpy(a.astype(np.int64)) for a in gs.edge_index)
    ref = coo_spmm(torch.from_numpy(gs.edge_weight), s, r, x, gs.num_nodes)

    adj, g2, plan = tl.auto_layout(gs, block=128, feat=16, device="cpu")
    perm = torch.from_numpy(plan.perm)
    out = spmm_any(adj, x[perm], gs.num_nodes)
    np.testing.assert_allclose(out.numpy(), ref[perm].numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(g2.node_features, gs.node_features[plan.perm])
    np.testing.assert_array_equal(g2.edge_index, tr.apply_ordering(gs, plan.perm).edge_index)


@pytest.mark.parametrize("fmt", ["banded", "hybrid", "coo"])
def test_build_layout_equals_jax_build(fmt):
    """Each form built from one plan, bitwise the JAX package's."""
    gs = scrambled(2048, band=128, seed=6, shortcut_frac=0.0 if fmt == "banded" else 0.1)
    s, r = gs.edge_index
    plan = jl.plan_layout(s, r, gs.num_nodes, block=256 if fmt == "banded" else 128, **JAX_RATES)
    if fmt == "coo":
        plan = plan._replace(format="coo", bandwidth=0, reordered=False,
                             perm=np.arange(gs.num_nodes))
    assert plan.format == fmt
    got = tl.build_layout(tl.LayoutPlan(*plan), s, r, gs.edge_weight, gs.num_nodes, device="cpu")
    want = jl.build_layout(plan, s, r, gs.edge_weight, gs.num_nodes)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((gs.num_nodes, 8)).astype(np.float32))
    ei = [torch.from_numpy(a.astype(np.int64)) for a in gs.edge_index]
    perm = torch.from_numpy(plan.perm)
    ref = coo_spmm(torch.from_numpy(gs.edge_weight), *ei, x, gs.num_nodes)[perm]
    np.testing.assert_allclose(spmm_any(got, x[perm], gs.num_nodes).numpy(), ref.numpy(),
                               rtol=2e-5, atol=2e-5)
    if fmt == "coo":
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        return
    band, jband = (got, want) if fmt == "banded" else (got.band, want.band)
    assert band.band.numpy().tobytes() == np.asarray(jband.band).tobytes()
    if fmt == "hybrid":
        for name in ("remainder_senders", "remainder_receivers", "remainder_weights"):
            np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))


def test_layout_entry_points_run_on_the_card_by_default(monkeypatch):
    """``build_layout`` and ``auto_layout`` default to ``cuda`` and raise
    without a card, rather than leaving the adjacency on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gs = scrambled(512, band=64, seed=3)
    s, r = gs.edge_index
    plan = tl.plan_layout(s, r, gs.num_nodes, block=128)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tl.build_layout(plan, s, r, gs.edge_weight, gs.num_nodes)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tl.auto_layout(gs, block=128)
    for p in (plan, plan._replace(format="coo")):
        adj = tl.build_layout(p, s, r, gs.edge_weight, gs.num_nodes, device="cpu")
        tensors = {"coo": lambda: adj, "banded": lambda: [adj.band],
                   "hybrid": lambda: [adj.band.band, adj.remainder_weights]}[p.format]()
        assert all(t.device.type == "cpu" for t in tensors)
