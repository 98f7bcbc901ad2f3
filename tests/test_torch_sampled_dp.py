"""Sampled data parallelism in the port against the JAX package.

The sharded loaders, bitwise against JAX's: ``SampledNodeLoader(num_shards=4)``
(fused and classic) and a sharded ``DeviceSeedLoader`` stack the same
per-shard batches and rows, each shard's sampling stream keyed by its
global index, so a process's shards tile the global stack; the final
partial batch pads the trailing shards (``tests/test_device_sampled_dp.py:
90``); ``pack_epoch_sharded`` packs the rows the iterator yields.

The steps, held to JAX's on a 4-shard mesh by one SGD step at lr 1 (its
update is the gradient): the host-sampled ``NodeGCN`` step
(``make_dp_train_step`` over a stacked ``SampledNodeBatch``) and the
device-sampled GCN and SAGE-multiset steps (``make_device_sampled_dp_step``).
The port merges a rank's shards into one batch, seeds first, where JAX runs
a shard a device, so loss, parameters and BatchNorm moments agree at rtol
1e-4 / atol 1e-5 (the moments' sums run in another order).  The
device-sampled steps run at a fanout of the largest in-degree, where every
in-edge is kept and the port's own draws sample what JAX's do.

Within the port: the device-sampled eval equals the sum of per-shard
single-device evals; the scanned mesh epoch (``Trainer(scan_epochs=True,
mesh=...)`` and ``make_device_sampled_dp_epoch_runner``) equals the stepwise
one bitwise on the CPU, dropout on; dropout's per-shard masks follow a
merged batch's layout; and the Trainer refuses an unsharded loader.
"""

import copy

import jax
import numpy as np
import optax
import pytest
import torch

import connectome_gnn_tpu.data as jd
import connectome_gnn_tpu.data.device_sampling as jds
import connectome_gnn_tpu.models.node_coo as jnc
import connectome_gnn_tpu.parallel as jp
import connectome_gnn_tpu_torch as tpk
import connectome_gnn_tpu_torch.data as td
import connectome_gnn_tpu_torch.data.device_sampling as tds
import connectome_gnn_tpu_torch.parallel as tp
from connectome_gnn_tpu_torch.models import load_jax_params
from connectome_gnn_tpu_torch.nn.layers import Dropout, region_major

D = 4
RTOL, ATOL = 1e-4, 1e-5
FIELDS = ("node_features", "senders", "receivers", "edge_weight", "node_mask", "labels",
          "label_mask", "seed_mask", "node_ids")


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def task(pkg, n=256, degree=4, band=16, seed=0):
    g = pkg.generate_spatial_graph(n, degree=degree, band=band, seed=seed, shortcut_frac=0.1)
    return g, (g.degree() > np.median(g.degree())).astype(np.int32)


@pytest.fixture(scope="module")
def graphs():
    return task(jd), task(td)


@pytest.fixture(scope="module")
def meshes(cpu_devices):
    return jp.create_mesh(devices=cpu_devices[:D]), tp.create_mesh((D,), ("data",), device="cpu")


# ---------------------------------------------------------------------------
# The sharded loaders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [True, False])
def test_sharded_sampled_loader_is_jax(graphs, fused):
    (jg, labels), (tg, _) = graphs
    kw = dict(batch_size=8 * D, fanout=(3, 2), seed=7, num_shards=D, fused=fused,
              seed_nodes=np.arange(72))
    port = td.SampledNodeLoader(tg, labels, device="cpu", **kw)
    got, want = list(port), list(jd.SampledNodeLoader(jg, labels, **kw))
    assert len(got) == len(want) == 3
    for t, j in zip(got, want):
        assert t.num_seeds == j.num_seeds == 8
        for name in FIELDS:
            np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                          err_msg=name)
    # the final partial batch (8 of 32 seeds) pads its trailing shards
    assert got[-1].seed_mask.sum(dim=1).tolist() == [8, 0, 0, 0]
    # a process's shards are its rows of the global stack
    port.set_epoch(0)
    whole = next(iter(port))
    for p in range(2):
        half = td.SampledNodeLoader(tg, labels, device="cpu", process_index=p, process_count=2,
                                    **kw)
        part = next(iter(half))
        for name in FIELDS:
            assert torch.equal(getattr(part, name), getattr(whole, name)[2 * p : 2 * p + 2]), name


def test_sharded_seed_loader_is_jax():
    labels = (np.arange(72) % 2).astype(np.int32)
    kw = dict(batch_size=32, seed=3, num_shards=8)
    port, ref = (tds.DeviceSeedLoader(np.arange(72), labels, device="cpu", **kw),
                 jds.DeviceSeedLoader(np.arange(72), labels, **kw))
    got, want = list(port), list(ref)
    assert len(got) == len(want) == 3
    for t, j in zip(got, want):
        assert t.stacked and t.packed.shape == (8, 3 + 2 * 4)
        np.testing.assert_array_equal(t.packed.numpy(), np.asarray(j.packed))
        for name in ("seeds", "seed_mask", "label_mask", "labels"):
            np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                          err_msg=name)
        np.testing.assert_array_equal(t.key_words.numpy(), np.asarray(j.key_data))
    port.set_epoch(0)
    ref.set_epoch(0)
    np.testing.assert_array_equal(tds.pack_epoch_sharded(port).numpy(),
                                  jds.pack_epoch_sharded(ref))
    stacks = [b.packed for b in got]
    for p in range(4):
        part = tds.DeviceSeedLoader(np.arange(72), labels, device="cpu", process_index=p,
                                    process_count=4, **kw)
        for b, whole in zip(part, stacks):
            assert torch.equal(b.packed, whole[2 * p : 2 * p + 2])
    last = tds.DeviceSeedLoader(np.arange(40), None, batch_size=32, num_shards=4, shuffle=False,
                                device="cpu")
    final = list(last)[-1]
    assert final.packed[:, 0].tolist() == [8, 0, 0, 0] and final.labeled is False
    with pytest.raises(ValueError, match="not divisible"):
        tds.DeviceSeedLoader(np.arange(8), batch_size=10, num_shards=4, device="cpu")
    with pytest.raises(ValueError, match="requires num_shards"):
        tds.DeviceSeedLoader(np.arange(8), process_index=0, process_count=2, device="cpu")
    with pytest.raises(ValueError, match="needs a sharded DeviceSeedLoader"):
        tds.pack_epoch_sharded(tds.DeviceSeedLoader(np.arange(8), batch_size=4, device="cpu"))


# ---------------------------------------------------------------------------
# The steps against JAX's
# ---------------------------------------------------------------------------


def assert_step_is_jax(tmodel, loss, n, jout):
    """Port step outputs against JAX's ``(params, state, opt, loss, n)``."""
    params, state, _, jloss, jn = jout
    assert float(n) == float(jn)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    want = copy.deepcopy(tmodel)
    load_jax_params(want, numpy_tree(params), numpy_tree(state))
    for name, t in tmodel.state_dict().items():
        if t.is_floating_point():
            torch.testing.assert_close(t, want.state_dict()[name], rtol=RTOL, atol=ATOL,
                                       msg=name)


def test_host_sampled_dp_step_is_jax(graphs, meshes):
    (jg, labels), (tg, _) = graphs
    jmesh, tmesh = meshes
    kw = dict(batch_size=8 * D, fanout=(4, 4), seed=7, num_shards=D, fused=False)
    jbatch = next(iter(jd.SampledNodeLoader(jg, labels, **kw)))
    tbatch = next(iter(td.SampledNodeLoader(tg, labels, device="cpu", **kw)))
    jm = jnc.NodeGCN(in_channels=5, hidden_dim=16, num_layers=2)
    params, state = jm.init(jax.random.PRNGKey(0))
    tm = tpk.NodeGCN(5, 16, num_layers=2)
    load_jax_params(tm, numpy_tree(params), numpy_tree(state))
    opt = optax.sgd(1.0)
    jout = jp.make_dp_train_step(jm, opt, jmesh)(params, state, opt.init(params),
                                                 jax.random.PRNGKey(1), jbatch)
    step = tp.make_dp_train_step(tm, torch.optim.SGD(tm.parameters(), lr=1.0), tmesh)
    loss, n = step(tmesh.place(tbatch))
    assert_step_is_jax(tm, loss, n, jout)


@pytest.mark.parametrize("kind", ["gcn", "sage-multiset"])
def test_device_sampled_dp_step_is_jax(graphs, meshes, kind):
    (jg, labels), (tg, _) = graphs
    jmesh, tmesh = meshes
    md = int(np.bincount(tg.edge_index[1]).max())  # keep-all: every in-edge drawn
    kw = dict(hidden_dim=16, fanout=(md, md))
    if kind == "gcn":
        jmodel, tmodel = jd.device_sampled_gcn(jg, **kw), td.device_sampled_gcn(tg, device="cpu", **kw)
    else:
        jmodel = jd.device_sampled_sage(jg, dedup=False, **kw)
        tmodel = td.device_sampled_sage(tg, dedup=False, device="cpu", **kw)
    params, state = jmodel.init(jax.random.PRNGKey(0))
    load_jax_params(tmodel, numpy_tree(params), numpy_tree(state))
    lkw = dict(batch_size=8 * D, seed=0, num_shards=D, drop_last=True)
    jbatch = next(iter(jmodel.make_loader(np.arange(tg.num_nodes), labels, **lkw)))
    tbatch = next(iter(tmodel.make_loader(np.arange(tg.num_nodes), labels, **lkw)))
    opt = optax.sgd(1.0)
    jout = jp.make_device_sampled_dp_step(jmodel, opt, jmesh)(
        params, state, opt.init(params), jax.random.PRNGKey(7), jbatch.packed,
        jp.replicate_csr(jmodel.csr, jmesh))
    step = tp.make_device_sampled_dp_step(tmodel, torch.optim.SGD(tmodel.parameters(), lr=1.0),
                                          tmesh)
    loss, n = step(tbatch.packed, tp.replicate_csr(tmodel.csr, tmesh))
    assert float(n) == 8 * D
    assert_step_is_jax(tmodel, loss, n, jout)


def test_device_sampled_eval_is_the_sum_of_shard_evals(graphs, meshes):
    _, (tg, labels) = graphs
    tmesh = meshes[1]
    model = td.device_sampled_gcn(tg, hidden_dim=16, fanout=(3, 3), device="cpu")
    batch = next(iter(model.make_loader(np.arange(256), labels, batch_size=64, seed=2,
                                        num_shards=D, shuffle=False)))
    loss_sum, correct, n = tp.make_device_sampled_dp_eval_step(model, tmesh)(batch.packed,
                                                                            model.csr)
    trainer = tpk.Trainer(model, device="cpu", prefetch_depth=0)
    rows = [tds.SeedBatch(packed=row, csr=model.csr, num_seeds=16) for row in batch.packed]
    per_shard = [trainer.evaluate([r]) for r in rows]
    assert int(n) == sum(e["total"] for e in per_shard) == 64
    assert int(correct) == sum(e["correct"] for e in per_shard)
    np.testing.assert_allclose(float(loss_sum), sum(e["loss"] * e["total"] for e in per_shard),
                               rtol=1e-5)
    mesh_trainer = tpk.Trainer(model, mesh=tmesh, prefetch_depth=0)
    ev = mesh_trainer.evaluate([batch])
    assert ev["total"] == 64 and ev["correct"] == int(correct)
    assert mesh_trainer.predict([batch], prefer_fused=False).shape == (64, 2)


# ---------------------------------------------------------------------------
# The scanned mesh epoch, dropout and the Trainer's errors
# ---------------------------------------------------------------------------


def training_state(trainer):
    opt = [v for s in trainer.optimizer.state.values() for v in s.values() if torch.is_tensor(v)]
    return (list(trainer.model.state_dict().values()) + opt
            + [g.get_state() for g in trainer.shard_generators])


@pytest.mark.parametrize("kind", ["gcn", "sage-multiset"])
def test_scanned_mesh_epoch_is_stepwise(graphs, meshes, kind):
    """``Trainer(scan_epochs=True, mesh=...)`` against the stepwise mesh loop
    over two epochs, dropout 0.3: bitwise on the CPU (the body is the same
    step; on the card it is one captured step replayed)."""
    _, (tg, labels) = graphs
    tmesh = meshes[1]
    if kind == "gcn":
        base = td.device_sampled_gcn(tg, hidden_dim=16, fanout=(3, 3), dropout=0.3, device="cpu")
    else:
        base = td.device_sampled_sage(tg, hidden_dim=16, fanout=(3, 3), dropout=0.3, dedup=False,
                                      device="cpu")
    runs = []
    for scan in (False, True):
        m = copy.deepcopy(base)
        loader = m.make_loader(np.arange(256), labels, batch_size=64, seed=0, num_shards=D,
                               drop_last=True)
        runs.append((tpk.Trainer(m, seed=0, mesh=tmesh, scan_epochs=scan, prefetch_depth=0),
                     loader))
    for _ in range(2):
        a, b = (t.train_epoch(lo) for t, lo in runs)
        assert a == b and np.isfinite(a)
    for x, y in zip(training_state(runs[0][0]), training_state(runs[1][0])):
        assert torch.equal(x, y)


def test_epoch_runner_is_the_stepwise_dp_step(graphs, meshes):
    _, (tg, labels) = graphs
    tmesh = meshes[1]
    base = td.device_sampled_sage(tg, hidden_dim=16, fanout=(3, 3), dedup=False, device="cpu")
    loader = base.make_loader(np.arange(256), labels, batch_size=64, seed=1, num_shards=D)
    packed = tds.pack_epoch_sharded(loader)
    a, b = copy.deepcopy(base), copy.deepcopy(base)
    step = tp.make_device_sampled_dp_step(a, torch.optim.Adam(a.parameters(), lr=1e-3), tmesh)
    stepwise = [step(row, a.csr) for row in packed]
    run = tp.make_device_sampled_dp_epoch_runner(b, torch.optim.Adam(b.parameters(), lr=1e-3),
                                                 tmesh)
    losses, ns = run(packed, b.csr)
    assert losses.tolist() == [float(x) for x, _ in stepwise]
    assert ns.tolist() == [float(n) for _, n in stepwise] == [64.0] * 4
    for x, y in zip(a.state_dict().values(), b.state_dict().values()):
        assert torch.equal(x, y)


def test_dropout_masks_follow_the_merged_layout():
    """A merged batch's dropout draws each shard's mask in the shard's own
    layout (``regions``): the masks a shard gets alone, moved."""
    regions = [3, 6, 12]
    x = torch.randn(4, sum(regions), 5)
    drop = Dropout(0.5)
    drop.shard_generators = [torch.Generator().manual_seed(s) for s in range(4)]
    got = drop(region_major(x, regions), regions)
    alone = []
    for s in range(4):
        one = Dropout(0.5)
        one.shard_generators = [torch.Generator().manual_seed(s)]
        alone.append(one(x[s]))
    assert torch.equal(got, region_major(torch.stack(alone), regions))


def test_mesh_mode_refuses_an_unsharded_loader(graphs, meshes):
    _, (tg, labels) = graphs
    tmesh = tp.create_mesh((2,), ("data",), device="cpu")
    model = td.device_sampled_gcn(tg, hidden_dim=8, fanout=(2, 2), device="cpu")
    plain = model.make_loader(np.arange(128), labels, batch_size=32, seed=0)
    with pytest.raises(ValueError, match="sharded DeviceSeedLoader"):
        tpk.Trainer(model, mesh=tmesh, prefetch_depth=0).train_epoch(plain)
    with pytest.raises(ValueError, match="num_shards=2"):
        tpk.Trainer(model, mesh=tmesh, scan_epochs=True, prefetch_depth=0).train_epoch(plain)
    wrong = model.make_loader(np.arange(128), labels, batch_size=32, num_shards=4)
    with pytest.raises(ValueError, match="num_shards=2"):
        tpk.Trainer(model, mesh=tmesh, scan_epochs=True, prefetch_depth=0).train_epoch(wrong)
    host = td.SampledNodeLoader(tg, labels, seed_nodes=np.arange(64), batch_size=32,
                                fanout=(2, 2), device="cpu")
    with pytest.raises(ValueError, match="SampledNodeLoader with num_shards=2"):
        tpk.Trainer(tpk.NodeGCN(5, 8), mesh=tmesh, prefetch_depth=0).train_epoch(host)
    sharded = td.SampledNodeLoader(tg, labels, seed_nodes=np.arange(64), batch_size=32,
                                   fanout=(2, 2), num_shards=2, device="cpu")
    trainer = tpk.Trainer(tpk.NodeGCN(5, 8), mesh=tmesh, prefetch_depth=0)
    assert np.isfinite(trainer.train_epoch(sharded))
    assert trainer.evaluate(sharded)["total"] == 64
    assert trainer.predict(sharded, prefer_fused=False).shape == (64, 2)
