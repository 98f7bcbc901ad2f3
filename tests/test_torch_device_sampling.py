"""Device-side sampling in the port against the JAX package's, and
``Trainer(scan_epochs=True)`` against the stepwise loop.

Bitwise against JAX: ``cap_in_degree_mask``; ``DeviceGraphCSR.from_graph``'s
arrays (packed and flat adjacency, float32, bfloat16 and int8 tables with
their per-column scales, an in-degree cap); the seed rows of ``pack_epoch``
and of a ``DeviceSeedLoader``'s iteration; ``device_sample`` in both modes
fed JAX's own uniform draws (``jax.random.split`` then ``uniform`` per hop),
on a graph whose in-degrees vary from 0 up (so draws are invalid where a
node has fewer in-edges than its fanout) and with padded seed slots: the
node ids and mask, the features, the flat edges and every hop block.

With its own draws (``hop_draws``, an integer hash) the port's sample
differs from JAX's, except where every in-edge is kept (fanout at least
the largest in-degree): there the eval logits of ``DeviceSampledModel``
match JAX's at rtol 1e-4 / atol 1e-5 (the order of float32 sums differs),
as ``TestKeepAllOracle`` (``tests/test_device_sampling.py:56``) holds.

Within the port: a scanned epoch equals the stepwise one bitwise on the
CPU, parameters, buffers, optimizer state and loss (GCN, SAGE multiset,
dropout on); ``fit`` likewise; and ``fit`` learns the one-hop task of
``tests/test_device_sampling.py:283``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import connectome_gnn_tpu.data as jd
import connectome_gnn_tpu.data.device_sampling as jds
import connectome_gnn_tpu_torch as tp
import connectome_gnn_tpu_torch.data as td
import connectome_gnn_tpu_torch.data.device_sampling as tds
from connectome_gnn_tpu_torch.models import load_jax_params

LOGIT_RTOL, LOGIT_ATOL = 1e-4, 1e-5
SPATIAL = dict(degree=8, band=64, shortcut_frac=0.1, seed=0)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def skewed_graph(pkg, n=600, e=3000, seed=0):
    """In-degrees from 0 to a hub's ~200: a third of the edges go to
    node 7, and every node past 500 receives none."""
    rng = np.random.default_rng(seed)
    dst = np.where(rng.random(e) < 1 / 15, 7, rng.integers(0, 500, e))
    src = rng.integers(0, n, e)
    return pkg.ConnectomeGraph(
        node_features=rng.standard_normal((n, 5)).astype(np.float32),
        edge_index=np.stack([src, dst]).astype(np.int32),
        edge_weight=rng.uniform(-1.0, 1.0, e).astype(np.float32),
    )


@pytest.fixture(scope="module")
def graphs():
    return {
        "spatial": (jd.generate_spatial_graph(4096, **SPATIAL),
                    td.generate_spatial_graph(4096, **SPATIAL)),
        "skewed": (skewed_graph(jd), skewed_graph(td)),
    }


def test_cap_in_degree_mask_is_jax(graphs):
    jg, tg = graphs["skewed"]
    for cap in (1, 3, 40):
        got = tds.cap_in_degree_mask(tg.edge_index[1], tg.edge_weight, cap)
        np.testing.assert_array_equal(got, jds.cap_in_degree_mask(jg.edge_index[1], jg.edge_weight,
                                                                 cap))
    ties = np.array([0.5, -0.5, 0.5, 0.25], np.float32)
    np.testing.assert_array_equal(tds.cap_in_degree_mask(np.zeros(4, np.int32), ties, 2),
                                  [True, True, False, False])
    with pytest.raises(ValueError, match=">= 1"):
        tds.cap_in_degree_mask(tg.edge_index[1], tg.edge_weight, 0)


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("feature_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("cap", [None, 5])
def test_from_graph_arrays_are_jax(graphs, packed, feature_dtype, cap):
    jg, tg = graphs["skewed"]
    kw = dict(packed=packed, feature_dtype=feature_dtype, in_degree_cap=cap)
    got, want = tds.DeviceGraphCSR.from_graph(tg, device="cpu", **kw), jds.DeviceGraphCSR.from_graph(jg, **kw)
    hub = int(np.bincount(tg.edge_index[1]).max())
    assert got.max_in_degree == want.max_in_degree == (cap or hub) and hub > 100
    for name in ("indptr", "senders", "edge_weight", "sender_weight", "feature_scale"):
        t, j = getattr(got, name), getattr(want, name)
        assert (t is None) == (j is None), name
        if t is not None:
            assert t.dtype == {"indptr": torch.int32, "senders": torch.int32,
                               "sender_weight": torch.int32}.get(name, torch.float32), name
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    feats = got.node_features
    if feature_dtype == "bfloat16":
        np.testing.assert_array_equal(feats.view(torch.int16).numpy(),
                                      np.asarray(want.node_features).view(np.int16))
    else:
        np.testing.assert_array_equal(feats.numpy(), np.asarray(want.node_features))
    idx = np.array([0, 7, 599, 7])
    np.testing.assert_array_equal(got.gather_features(torch.from_numpy(idx)).numpy(),
                                  np.asarray(want.gather_features(jnp.asarray(idx))))
    assert got.nbytes == sum(np.asarray(a).nbytes for a in (
        want.indptr, want.node_features, want.senders, want.edge_weight, want.sender_weight,
        want.feature_scale) if a is not None)


def test_from_graph_refuses_a_bad_dtype(graphs):
    with pytest.raises(ValueError, match="feature_dtype"):
        tds.DeviceGraphCSR.from_graph(graphs["skewed"][1], feature_dtype="float16", device="cpu")


@pytest.mark.parametrize("labelled", [True, False])
def test_seed_rows_are_jax(labelled):
    """``pack_epoch``'s buffer and the loader's rows, two epochs, with a
    partial last batch; and the batch's views."""
    labels = np.random.default_rng(0).integers(0, 4, 700).astype(np.int32) if labelled else None
    kw = dict(batch_size=64, seed=9)
    pool = np.random.default_rng(1).choice(700, 300, replace=False)
    port, ref = tds.DeviceSeedLoader(pool, labels, device="cpu", **kw), jds.DeviceSeedLoader(pool, labels, **kw)
    np.testing.assert_array_equal(tds.pack_epoch(port).numpy(), np.asarray(jds.pack_epoch(ref)))
    got, want = list(port), list(ref)
    assert len(got) == len(want) == len(port) == 5
    for t, j in zip(got, want):
        np.testing.assert_array_equal(t.packed.numpy(), np.asarray(j.packed))
        for name in ("seeds", "seed_mask", "label_mask", "labels", "graph_mask"):
            np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                          err_msg=name)
        np.testing.assert_array_equal(t.key_words.numpy(), np.asarray(j.key_data))
    one = tds.make_seed_batch(pool[:10], labels, 123, 16, device="cpu")
    np.testing.assert_array_equal(one.packed.numpy(),
                                  np.asarray(jds.make_seed_batch(pool[:10], labels, 123, 16).packed))
    sharded = tds.DeviceSeedLoader(pool, batch_size=16, num_shards=2, device="cpu")
    assert next(iter(sharded)).packed.shape == (2, 3 + 2 * 8)
    with pytest.raises(ValueError, match="requires num_shards"):
        tds.DeviceSeedLoader(pool, process_index=0, process_count=2, device="cpu")


def jax_draws(key, rows, fanout, max_deg):
    draws = []
    for f in fanout:
        key, sub = jax.random.split(key)
        draws.append(torch.from_numpy(np.array(jax.random.uniform(sub, (rows, max_deg)))))
        rows *= f
    return draws


@pytest.mark.parametrize("graph,fanout", [("spatial", (4, 3)), ("skewed", (6, 4)),
                                          ("skewed", (3, 2, 2))])
@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("packed", [True, False])
def test_device_sample_fed_jax_draws_is_jax(graphs, graph, fanout, dedup, packed):
    jg, tg = graphs[graph]
    n = tg.num_nodes
    seeds = np.random.default_rng(3).choice(n, 48, replace=False)
    seeds[[5, 40, 47]] = -1  # padding slots
    if graph == "skewed":
        seeds[:3] = [7, 599, 550]  # the hub and nodes with no in-edge
    tcsr = tds.DeviceGraphCSR.from_graph(tg, packed=packed, device="cpu")
    jcsr = jds.DeviceGraphCSR.from_graph(jg, packed=packed)
    key = jax.random.PRNGKey(11)
    draws = jax_draws(key, 48, fanout, max(tcsr.max_in_degree, *fanout))
    got = tds.device_sample(tcsr, torch.from_numpy(seeds), None, fanout, dedup=dedup, draws=draws)
    want = jax.jit(jds.device_sample, static_argnums=3, static_argnames="dedup")(
        jcsr, jnp.asarray(seeds, jnp.int32), key, fanout, dedup=dedup)
    assert got.num_seeds == want.num_seeds == 48
    for name in ("node_ids", "node_mask", "node_features", "senders", "receivers", "edge_weight"):
        t, j = getattr(got, name), np.asarray(getattr(want, name))
        assert t.shape == j.shape, name
        np.testing.assert_array_equal(t.numpy(), j, err_msg=name)
    assert len(got.hop_blocks) == len(want.hop_blocks) == len(fanout)
    for h, (t, j) in enumerate(zip(got.hop_blocks, want.hop_blocks)):
        for name in ("senders", "weights", "recv"):
            np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                          err_msg=f"hop {h} {name}")
        if dedup:  # multiset's static starts leave jit as arrays
            assert t.sender_start is t.recv_start is j.sender_start is j.recv_start is None
        else:
            assert (t.sender_start, t.recv_start) == (int(j.sender_start), int(j.recv_start))
    if graph == "skewed":  # the hub keeps its fanout; node 599 has no in-edge
        assert bool(got.hop_blocks[0].weights[0].all()) and not got.hop_blocks[0].weights[1].any()


def test_hop_draws_are_a_function_of_key_hop_and_slot():
    key = torch.tensor([0, 2**31 + 5])
    u = tds.hop_draws(key, 0, (64, 40))
    assert u.dtype == torch.float32 and u.shape == (64, 40)
    assert bool((u >= 0).all() and (u < 1).all())
    assert torch.equal(u, tds.hop_draws(key.clone(), 0, (64, 40)))
    assert torch.equal(u.view(-1)[:640], tds.hop_draws(key, 0, (16, 40)).view(-1))
    others = [tds.hop_draws(key, 1, (64, 40)), tds.hop_draws(key + torch.tensor([0, 1]), 0, (64, 40)),
              tds.hop_draws(key + torch.tensor([1, 0]), 0, (64, 40))]
    for v in others:
        assert float((u == v).float().mean()) < 1e-3
    every = torch.cat([u.view(-1)] + [v.view(-1) for v in others])
    assert abs(float(every.mean()) - 0.5) < 0.01 and abs(float(every.var()) - 1 / 12) < 0.005
    # the hash needs no product past 2^63: the largest word against every constant
    words = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**32 - 1])
    np.testing.assert_array_equal(tds._mul32(words, 0x846CA68B).numpy(),
                                  (words.numpy().astype(object) * 0x846CA68B) % 2**32)


@pytest.mark.parametrize("kind,dedup", [("gcn", True), ("sage", True), ("sage", False)])
def test_keep_all_eval_logits_match_jax(graphs, kind, dedup):
    """Every in-edge kept: the port's own draws and JAX's give the same
    edges, so a ``DeviceSampledModel`` with JAX's weights gives JAX's
    logits."""
    jg, tg = graphs["spatial"]
    F_ = 8  # every node's in-degree
    make_t = td.device_sampled_gcn if kind == "gcn" else td.device_sampled_sage
    make_j = jd.device_sampled_gcn if kind == "gcn" else jd.device_sampled_sage
    kw = {} if kind == "gcn" else dict(dedup=dedup)
    tmodel = make_t(tg, hidden_dim=16, fanout=(F_, F_), device="cpu", **kw)
    jmodel = make_j(jg, hidden_dim=16, fanout=(F_, F_), **kw)
    params, state = jmodel.init(jax.random.PRNGKey(2))
    load_jax_params(tmodel, numpy_tree(params), numpy_tree(state))
    chunk = np.array([7, 3, 4095, 42, 120])
    labels = np.zeros(4096, np.int32)
    want, _ = jax.jit(jmodel.apply)(params, state, jds.make_seed_batch(chunk, labels, 17, 8))
    got = tmodel.eval()(tds.make_seed_batch(chunk, labels, 17, 8, csr=tmodel.csr))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=LOGIT_RTOL,
                               atol=LOGIT_ATOL)


def test_multiset_needs_a_multiset_safe_model(graphs):
    with pytest.raises(ValueError, match="multiset"):
        tds.DeviceSampledModel(None, tp.NodeGCN(5, 8), (2, 2), dedup=False)


def trainer_pair(model_fn, labels, batch_size, **kw):
    """Two trainers on copies of one model, stepwise and scanned, with
    their loaders."""
    model = model_fn()
    out = []
    for scan in (False, True):
        m = copy.deepcopy(model)
        loader = m.make_loader(np.arange(len(labels)), labels, batch_size=batch_size, seed=4, **kw)
        out.append((tp.Trainer(m, device="cpu", seed=0, scan_epochs=scan), loader))
    return out


def training_state(trainer):
    opt = [v for s in trainer.optimizer.state.values() for v in s.values() if torch.is_tensor(v)]
    return list(trainer.model.state_dict().values()) + opt + [trainer.generator.get_state()]


@pytest.mark.parametrize("kind,dropout", [("gcn", 0.0), ("gcn", 0.3), ("sage-multiset", 0.3)])
def test_scan_epochs_is_the_stepwise_loop_bitwise(graphs, kind, dropout):
    _, tg = graphs["spatial"]
    labels = (np.arange(tg.num_nodes) % 2).astype(np.int32)
    if kind == "gcn":
        make = lambda: td.device_sampled_gcn(tg, hidden_dim=16, fanout=(4, 3), dropout=dropout,  # noqa: E731
                                             device="cpu")
    else:
        make = lambda: td.device_sampled_sage(tg, hidden_dim=16, fanout=(4, 3), dropout=dropout,  # noqa: E731
                                              dedup=False, device="cpu")
    (t1, l1), (t2, l2) = trainer_pair(make, labels[:1024], 128, drop_last=True)
    for _ in range(2):
        a, b = t1.train_epoch(l1), t2.train_epoch(l2)
        assert a == b and t1.last_skipped_steps == t2.last_skipped_steps == 0
    for x, y in zip(training_state(t1), training_state(t2)):
        assert torch.equal(x, y)
    assert t1.evaluate(l1) == t2.evaluate(l2)


def test_fit_with_scan_epochs_is_the_stepwise_fit(graphs):
    _, tg = graphs["spatial"]
    labels = (tg.node_features[:1000, 0] > 0).astype(np.int32)
    make = lambda: td.device_sampled_gcn(tg, hidden_dim=16, fanout=(4, 3), device="cpu")  # noqa: E731
    (t1, tr1), (t2, tr2) = trainer_pair(make, labels, 200)
    hist = [t.fit(tr, t.model.make_loader(np.arange(1000), labels, batch_size=200, shuffle=False),
                  num_epochs=3, patience=5, verbose=False)
            for t, tr in ((t1, tr1), (t2, tr2))]
    assert hist[0] == hist[1]
    for x, y in zip(training_state(t1), training_state(t2)):
        assert torch.equal(x, y)


def test_scan_epochs_refuses_what_it_cannot_run(graphs):
    _, tg = graphs["spatial"]
    model = td.device_sampled_gcn(tg, hidden_dim=8, fanout=(2, 2), device="cpu")
    loader = model.make_loader(np.arange(256), np.zeros(256, np.int32), batch_size=64)
    with pytest.raises(ValueError, match="DeviceSampledModel"):
        tp.Trainer(tp.NodeGCN(5, 8), device="cpu", scan_epochs=True).train_epoch(loader)
    elsewhere = td.DeviceSeedLoader(np.arange(256), np.zeros(256, np.int32), batch_size=64,
                                    csr=model.csr.to("meta"), device="cpu")
    with pytest.raises(ValueError, match="lies on meta"):
        tp.Trainer(model, device="cpu", scan_epochs=True).train_epoch(elsewhere)
    on_meta = tds.DeviceSampledModel(model.csr.to("meta"), model.inner, (2, 2))
    with pytest.raises(ValueError, match="CSR does not move"):
        tp.Trainer(on_meta, device="cpu")
    with pytest.raises(ValueError, match="lies on meta"):
        on_meta(tds.make_seed_batch(np.arange(4), None, 1, 4, device="cpu"))
    # a host-sampled loader is not scanned: it trains stepwise
    host = td.SampledNodeLoader(tg, np.zeros(tg.num_nodes, np.int32), seed_nodes=np.arange(128),
                                batch_size=64, fanout=(2, 2), device="cpu")
    assert np.isfinite(tp.Trainer(tp.NodeGCN(5, 8), device="cpu", scan_epochs=True).train_epoch(host))


def test_fit_learns_the_one_hop_task():
    """``tests/test_device_sampling.py:283``'s task through the port."""
    g = td.generate_spatial_graph(1024, degree=8, band=32, seed=0)
    src, dst = g.edge_index
    num, den = np.zeros(g.num_nodes), np.zeros(g.num_nodes)
    np.add.at(num, dst, g.edge_weight * g.node_features[src, 0])
    np.add.at(den, dst, g.edge_weight)
    agg = num / (den + 1e-8)
    labels = (agg > np.median(agg)).astype(np.int32)
    model = td.device_sampled_gcn(g, hidden_dim=32, fanout=(8, 8), device="cpu")
    tr = model.make_loader(np.arange(1024), labels, batch_size=128, seed=0, drop_last=True)
    va = model.make_loader(np.arange(1024), labels, batch_size=128, seed=1, shuffle=False)
    assert tr.csr is model.csr
    hist = tp.Trainer(model, device="cpu", seed=0, scan_epochs=True).fit(
        tr, va, num_epochs=4, patience=10, verbose=False)
    assert hist["train_loss"][-1] < hist["train_loss"][0]
    assert hist["val_acc"][-1] > 0.6


@pytest.mark.parametrize("path", ["host-sampled", "device-sampled", "scanned"])
def test_fit_resumes_bitwise_and_predicts(graphs, tmp_path, path):
    """A fit stopped after 2 epochs and resumed from its checkpoint by a
    new Trainer (loaders re-pinned by ``set_epoch``) equals an
    uninterrupted 4-epoch fit bitwise, dropout on; ``predict`` then serves
    the real seeds of a partial last batch."""
    _, tg = graphs["spatial"]
    labels = (tg.node_features[:, 0] > 0).astype(np.int32)
    pool = np.arange(300) * 11

    def run(epochs, **checkpoint):
        if path == "host-sampled":
            model = tp.NodeSAGE(5, 16, dropout=0.3)
            make = lambda shuffle, seed: td.SampledNodeLoader(  # noqa: E731
                tg, labels, seed_nodes=pool, batch_size=64, fanout=(4, 3), shuffle=shuffle,
                seed=seed, device="cpu")
        else:
            model = td.device_sampled_gcn(tg, hidden_dim=16, fanout=(4, 3), dropout=0.3, device="cpu")
            make = lambda shuffle, seed: model.make_loader(pool, labels, batch_size=64,  # noqa: E731
                                                            shuffle=shuffle, seed=seed)
        trainer = tp.Trainer(model, device="cpu", seed=5, scan_epochs=path == "scanned")
        history = trainer.fit(make(True, 1), make(False, 2), num_epochs=epochs, patience=10,
                              verbose=False, **checkpoint)
        return trainer, history, make(False, 3)

    ref, h_ref, serve = run(4)
    run(2, checkpoint_dir=str(tmp_path))
    resumed, h_resumed, _ = run(4, checkpoint_dir=str(tmp_path), resume=True)
    assert h_resumed == h_ref and len(h_ref["train_loss"]) == 4
    for x, y in zip(training_state(resumed), training_state(ref)):
        assert torch.equal(x, y)
    with pytest.warns(UserWarning, match="COO"):
        out = ref.predict(serve)
    assert out.shape == (300, 2) and np.isfinite(out).all()
