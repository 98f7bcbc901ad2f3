"""Graph-sharded sampling in the port against the JAX package.

Mirrors ``tests/test_sharded_sampling.py`` on a 4-shard mesh in one process
(the JAX side: 4 virtual CPU devices), at 64·D nodes, hidden 16:

* ``ShardedGraphCSR.partition`` and ``partition_streamed`` (chunked, capped
  and uncapped, with a ``shard_range``) bitwise JAX's;
* the sample, fed JAX's owner-keyed draws (``fold_in(fold_in(sub, r), s)``
  of the owner's key, the module docstring's keying): both exchanges'
  node ids, masks, features, flat edges, hop blocks and overflow counts
  bitwise JAX's, also on JAX's adversarial frontier, where every request
  of one shard goes to one remote owner and overflows;
* under the port's own draws (``owner_draws``), the compacted exchange is
  bitwise the broadcast one whenever nothing overflows, and its drops are
  deterministic where something does;
* the keep-all oracle: at a fanout of the largest in-degree the sharded
  eval logits equal the port's unsharded multiset ``DeviceSampledModel``'s
  (rtol 1e-4 / atol 1e-5);
* the census and ``plan_compaction``'s config equal JAX's on the same
  probes;
* the compacted exchange's train step (SGD at lr 1, whose update is the
  gradient) and the broadcast exchange's eval step against JAX's at rtol
  1e-4 / atol 1e-5;
* the Trainer's graph-sharded dispatch: fit and evaluate through the
  model's loader, the step cache re-keyed by a re-planned config (stale
  steps dropped), the overflow it reports, and its errors.
"""

import copy
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import connectome_gnn_tpu.data as jd
import connectome_gnn_tpu.parallel as jp
from connectome_gnn_tpu.models.node_coo import BlockedNodeSAGE as JSAGE
from connectome_gnn_tpu.parallel import sharded_sampling as jss

import connectome_gnn_tpu_torch as tpk
import connectome_gnn_tpu_torch.data as td
import connectome_gnn_tpu_torch.parallel as tp
from connectome_gnn_tpu_torch.models import load_jax_params
from connectome_gnn_tpu_torch.parallel import sharded_sampling as tss

D = 4
RTOL, ATOL = 1e-4, 1e-5
SEEDS = np.array([[3, 17, 40], [70, 140, 90], [150, 200, -1], [33, 255, 8]], np.int32)
NAMES = ("node_features", "senders", "receivers", "edge_weight", "node_mask", "node_ids")


def spatial(pkg, n=64 * D, degree=5, band=24, seed=0, shortcut_frac=0.2):
    return pkg.generate_spatial_graph(n, degree=degree, band=band, seed=seed,
                                      shortcut_frac=shortcut_frac)


def jax_keys(n, base=100):
    return np.stack([np.asarray(jax.random.key_data(jax.random.PRNGKey(base + r)))
                     for r in range(n)])


def port_config(comp):
    if comp is None:
        return None
    return tss.CompactionConfig(comp.alpha, comp.rounds, comp.dedup_features, comp.alpha_features,
                                comp.rounds_features)


def jax_draws(keys, S, fanout, max_deg):
    """JAX's owner-side uniforms, one ``[D (owner), D (requester), Fb,
    max_deg]`` tensor a hop: owner ``o`` splits its own key a hop and draws
    requester ``r``'s slot ``s`` from ``fold_in(fold_in(sub, r), s)``."""
    out = [[] for _ in fanout]
    for o in range(len(keys)):
        key, Fb = jax.random.wrap_key_data(jnp.asarray(keys[o])), S
        for h, f in enumerate(fanout):
            key, sub = jax.random.split(key)
            req = jax.vmap(lambda r, sub=sub: jax.random.fold_in(sub, r))(
                jnp.arange(len(keys), dtype=jnp.uint32))
            slots = jnp.broadcast_to(jnp.arange(Fb, dtype=jnp.int32)[None], (len(keys), Fb))
            out[h].append(np.asarray(jax.vmap(jss._slot_uniforms, in_axes=(0, 0, None))(
                req, slots, max_deg)))
            Fb *= min(f, max_deg)
    return [torch.from_numpy(np.stack(u)) for u in out]


@pytest.fixture(scope="module")
def setup(cpu_devices):
    jg, tg = spatial(jd), spatial(td)
    return dict(jg=jg, tg=tg, jsg=jp.ShardedGraphCSR.partition(jg, D),
                tsg=tss.ShardedGraphCSR.partition(tg, D, device="cpu"),
                jmesh=jp.create_mesh(devices=cpu_devices[:D]),
                tmesh=tp.create_mesh((D,), ("data",), device="cpu"))


def jax_sample(jmesh, jsg, seeds, keys, fanout, comp):
    @jax.jit
    @partial(jax.shard_map, mesh=jmesh, in_specs=(P("data"),) * 3,
             out_specs=(P("data"), P("data")))
    def run(gs, sd, kd):
        b, ovf = jss.sharded_device_sample_with_stats(gs, sd[0], jax.random.wrap_key_data(kd[0]),
                                                      fanout, compaction=comp)
        tree = tuple(getattr(b, n) for n in NAMES) + (
            tuple(h.senders for h in b.hop_blocks), tuple(h.weights for h in b.hop_blocks))
        return jax.tree_util.tree_map(lambda a: a[None], tree), ovf[None]

    tree, ovf = run(jsg, jnp.asarray(seeds), jnp.asarray(keys))
    return jax.tree_util.tree_map(np.asarray, tree), np.asarray(ovf)


def port_sample(s, seeds, keys, fanout, comp, draws=None):
    batches, ovf = tss.sharded_device_sample_with_stats(
        s["tsg"], torch.from_numpy(seeds), torch.from_numpy(keys.astype(np.int64)), fanout,
        s["tmesh"], compaction=comp, draws=draws)
    tree = tuple(np.stack([getattr(b, n).numpy() for b in batches]) for n in NAMES)
    blocks = tuple(tuple(np.stack([getattr(b.hop_blocks[h], k).numpy() for b in batches])
                         for h in range(len(fanout))) for k in ("senders", "weights"))
    return tree + blocks, ovf.numpy()


def assert_same(got, want, msg=""):
    for a, b, name in zip(got, want, NAMES + ("hop senders", "hop weights")):
        for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
            np.testing.assert_array_equal(x, y, err_msg=f"{msg} {name}")


# ---------------------------------------------------------------------------
# The partition
# ---------------------------------------------------------------------------


def skewed(pkg, seed=11, n=200, hub_extra=60):
    """A spatial graph plus two hub receivers, one with tied weights."""
    g = spatial(pkg, n=n, seed=seed)
    rng = np.random.default_rng(seed)
    dst = np.concatenate([np.zeros(hub_extra, np.int64), np.full(hub_extra, 5, np.int64)])
    src = rng.integers(0, n, size=2 * hub_extra)
    w = np.concatenate([rng.uniform(0.1, 1.0, hub_extra).astype(np.float32),
                        np.full(hub_extra, 0.25, np.float32)])
    return pkg.ConnectomeGraph(
        node_features=g.node_features,
        edge_index=np.stack([np.concatenate([g.edge_index[0], src]),
                             np.concatenate([g.edge_index[1], dst])]),
        edge_weight=np.concatenate([g.edge_weight, w]))


@pytest.mark.parametrize("cap", [None, 6])
@pytest.mark.parametrize("made", ["in memory", "streamed by 23", "streamed range (1, 3)"])
def test_partition_is_jax(made, cap):
    jg, tg = skewed(jd), skewed(td)
    src, dst = tg.edge_index
    w = tg.edge_weight
    chunk = 23 if made == "streamed by 23" else 10**9

    def chunks():
        for a in range(0, len(w), chunk):
            yield src[a : a + chunk], dst[a : a + chunk], w[a : a + chunk]

    want = jp.ShardedGraphCSR.partition(jg, D, in_degree_cap=cap)
    lo, hi = 0, D
    if made == "in memory":
        got = tss.ShardedGraphCSR.partition(tg, D, in_degree_cap=cap, device="cpu")
    else:
        lo, hi = (1, 3) if "range" in made else (0, D)
        asked = []
        got = tss.ShardedGraphCSR.partition_streamed(
            chunks, lambda a, b: asked.append((a, b)) or tg.node_features[a:b], tg.num_nodes, D,
            shard_range=(lo, hi), in_degree_cap=cap, device="cpu")
        assert all(a >= lo * got.nodes_per_shard and b <= hi * got.nodes_per_shard
                   for a, b in asked)
    assert (got.nodes_per_shard, got.max_in_degree, got.num_nodes, got.num_shards, got.shard_lo,
            got.held) == (want.nodes_per_shard, want.max_in_degree, want.num_nodes, D, lo, hi - lo)
    for name in ("indptr", "sender_weight", "node_features"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name))[lo:hi], err_msg=name)
    if cap is not None:
        assert got.max_in_degree == cap


# ---------------------------------------------------------------------------
# The sample
# ---------------------------------------------------------------------------

CONFIGS = {
    "broadcast": None,
    "compacted, carry-over rounds": jss.CompactionConfig(alpha=1.0, rounds=4),
    "compacted, overflowing slot-wise": jss.CompactionConfig(alpha=0.5, rounds=1,
                                                             dedup_features=False),
    "compacted, per-stage": jss.CompactionConfig(alpha=2.0, rounds=2, alpha_features=1.25,
                                                 rounds_features=1),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sample_fed_jax_draws_is_jax(setup, name):
    comp, fanout = CONFIGS[name], (3, 3)
    keys = jax_keys(D)
    draws = jax_draws(keys, 3, fanout, max(setup["tsg"].max_in_degree, 3))
    want, want_ovf = jax_sample(setup["jmesh"], setup["jsg"], SEEDS, keys, fanout, comp)
    got, ovf = port_sample(setup, SEEDS, keys, fanout, port_config(comp), draws)
    assert_same(got, want, name)
    np.testing.assert_array_equal(ovf, want_ovf)
    assert (ovf > 0).any() == name.endswith(("slot-wise", "per-stage"))


def test_adversarial_overflow_is_jax(cpu_devices):
    """Shard 0's seeds all owned by shard 1 at one slot of capacity a pair
    and a round (``tests/test_sharded_sampling.py:451``): the dropped
    requests and the overflow counts are JAX's."""
    jg = jd.generate_spatial_graph(64, degree=3, band=8, shortcut_frac=0.0)
    tg = td.generate_spatial_graph(64, degree=3, band=8, shortcut_frac=0.0)
    s = dict(jsg=jp.ShardedGraphCSR.partition(jg, D),
             tsg=tss.ShardedGraphCSR.partition(tg, D, device="cpu"),
             tmesh=tp.create_mesh((D,), ("data",), device="cpu"))
    P_ = s["tsg"].nodes_per_shard
    seeds = np.stack([np.arange(P_, P_ + 4), np.arange(P_ + 4, P_ + 8),
                      np.arange(2 * P_, 2 * P_ + 4), np.arange(3 * P_, 3 * P_ + 4)]).astype(np.int32)
    md = max(s["tsg"].max_in_degree, 1)
    comp = jss.CompactionConfig(alpha=1.0, rounds=1, dedup_features=False)
    keys = jax_keys(D)
    want, want_ovf = jax_sample(jp.create_mesh(devices=cpu_devices[:D]), s["jsg"], seeds, keys,
                                (md,), comp)
    got, ovf = port_sample(s, seeds, keys, (md,), port_config(comp), jax_draws(keys, 4, (md,), md))
    assert_same(got, want, "adversarial")
    np.testing.assert_array_equal(ovf, want_ovf)
    assert ovf[0] > 0


def test_compacted_is_broadcast_under_the_ports_draws(setup):
    """Seeded sweep of graphs, seeds and configs with the port's own draws:
    bitwise the broadcast oracle where nothing overflows, the same drops
    twice where something does."""
    rng = np.random.default_rng(42)
    tmesh, exact, dropped = setup["tmesh"], 0, 0
    for _ in range(6):
        g = td.generate_spatial_graph(192, degree=int(rng.integers(3, 7)),
                                      band=int(rng.integers(12, 40)), seed=int(rng.integers(1000)),
                                      shortcut_frac=float(rng.uniform(0.0, 0.4)))
        s = dict(tsg=tss.ShardedGraphCSR.partition(g, D, device="cpu"), tmesh=tmesh)
        seeds = rng.integers(-1, 192, size=(D, 3)).astype(np.int32)
        keys = rng.integers(0, 2**32, size=(D, 2))
        fanout = (int(rng.integers(2, 4)), int(rng.integers(2, 4)))
        comp = tss.CompactionConfig(alpha=float(rng.uniform(0.5, 4.0)),
                                    rounds=int(rng.integers(1, 4)),
                                    dedup_features=bool(rng.integers(0, 2)),
                                    alpha_features=float(rng.uniform(0.5, 4.0)),
                                    rounds_features=int(rng.integers(1, 3)))
        ref, _ = port_sample(s, seeds, keys, fanout, None)
        got, ovf = port_sample(s, seeds, keys, fanout, comp)
        if ovf.sum() == 0:
            assert_same(got, ref, str(comp))
            exact += 1
        else:
            again, ovf2 = port_sample(s, seeds, keys, fanout, comp)
            np.testing.assert_array_equal(ovf, ovf2)
            assert_same(got, again, str(comp))
            dropped += 1
    assert exact and dropped


def test_keep_all_eval_logits_are_the_unsharded_samplers(setup):
    """Fanout at the largest in-degree keeps every in-edge: the sharded
    sampler's eval logits equal the unsharded multiset sampler's (both the
    port's own draws)."""
    tg, tmesh = setup["tg"], setup["tmesh"]
    F_ = setup["tsg"].max_in_degree
    inner = tpk.NodeSAGE(5, 16, num_layers=2)
    fwd = tp.make_graph_sharded_sampled_forward(inner, tmesh, (F_, F_))
    keys = np.arange(2 * D).reshape(D, 2)
    got = fwd(setup["tsg"], torch.from_numpy(SEEDS), torch.from_numpy(keys))
    single = td.DeviceSampledModel(td.DeviceGraphCSR.from_graph(tg, device="cpu"), inner,
                                   (F_, F_), dedup=False).eval()
    for r in range(D):
        want = single(td.make_seed_batch(np.array([s for s in SEEDS[r] if s >= 0]), None, 50 + r,
                                         3, device="cpu"))
        torch.testing.assert_close(got[r], want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# The census and the planner
# ---------------------------------------------------------------------------


def test_census_and_plan_are_jax(setup):
    jg, fanout, S = spatial(jd, n=512), (3, 3), 16
    tg = spatial(td, n=512)
    jsg, tsg = jp.ShardedGraphCSR.partition(jg, D), tss.ShardedGraphCSR.partition(tg, D, device="cpu")
    seeds = np.random.default_rng(0).integers(0, 512, size=(3, D, S)).astype(np.int32)
    key = jax.random.PRNGKey(7)
    want, want_loads = jp.plan_compaction(jsg, setup["jmesh"], seeds, key, fanout,
                                          return_loads=True)
    # JAX probes step t, shard d with fold_in(fold_in(key, t), d)
    keys = np.stack([np.stack([np.asarray(jax.random.key_data(jax.random.fold_in(
        jax.random.fold_in(key, t), d))) for d in range(D)]) for t in range(3)])
    md = max(tsg.max_in_degree, 3)
    draws = [jax_draws(keys[t], S, fanout, md) for t in range(3)]
    got, loads = tp.plan_compaction(tsg, setup["tmesh"], seeds, keys.astype(np.int64), fanout,
                                    draws=draws, return_loads=True)
    assert loads == want_loads and loads["feature_load"] > 0
    assert got == port_config(want)
    # the planned config is exact on a probed step under the port's draws too
    own_seeds, own_keys = seeds[0], tss.probe_key_words(5, 1, D)[0]
    planned = tp.plan_compaction(tsg, setup["tmesh"], own_seeds, 5, fanout)
    s = dict(tsg=tsg, tmesh=setup["tmesh"])
    ref, _ = port_sample(s, own_seeds, own_keys, fanout, None)
    out, ovf = port_sample(s, own_seeds, own_keys, fanout, planned)
    assert ovf.sum() == 0
    assert_same(out, ref, "planned")
    with pytest.raises(ValueError, match="num_shards"):
        tp.plan_compaction(tsg, setup["tmesh"], np.zeros((3, 5), np.int32), 0, fanout)


# ---------------------------------------------------------------------------
# The steps against JAX's
# ---------------------------------------------------------------------------


def test_train_and_eval_steps_are_jax(setup):
    """The compacted exchange's train step (with the guard and the overflow
    count) and the broadcast exchange's eval step against JAX's."""
    comp, fanout = CONFIGS["compacted, carry-over rounds"], (4, 4)
    rng = np.random.default_rng(1)
    seeds = rng.permutation(256)[: D * 8].reshape(D, 8).astype(np.int32)
    labels = (seeds % 2).astype(np.int32)
    mask = np.ones_like(seeds, bool)
    keys = jax_keys(D, base=300)
    draws = jax_draws(keys, 8, fanout, max(setup["tsg"].max_in_degree, 4))
    jm = JSAGE(in_channels=5, hidden_dim=16, num_layers=2)
    params, state = jm.init(jax.random.PRNGKey(0))
    tm = tpk.NodeSAGE(5, 16, num_layers=2)
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, params),
                    jax.tree_util.tree_map(np.asarray, state))
    args = [jnp.asarray(a) for a in (seeds, keys, labels, mask)]
    targs = [torch.from_numpy(a) for a in (seeds, keys.astype(np.int64), labels, mask)]

    ev = jp.make_graph_sharded_eval_step(jm, setup["jmesh"], fanout)
    want_ev = [float(x) for x in ev(params, state, setup["jsg"], *args)]
    tev = tp.make_graph_sharded_eval_step(tm, setup["tmesh"], fanout)
    got_ev = [float(x) for x in tev(setup["tsg"], *targs, draws=draws)]
    np.testing.assert_allclose(got_ev, want_ev, rtol=RTOL)

    opt = optax.sgd(1.0)
    step = jp.make_graph_sharded_train_step(jm, opt, setup["jmesh"], fanout, compaction=comp,
                                            guard=True)
    out = step(params, state, opt.init(params), jax.random.PRNGKey(1), setup["jsg"], *args)
    tstep = tp.make_graph_sharded_train_step(tm, torch.optim.SGD(tm.parameters(), lr=1.0),
                                             setup["tmesh"], fanout, compaction=port_config(comp),
                                             guard=True)
    got = tstep(setup["tsg"], *targs, draws=draws)
    assert len(got) == len(out) - 3 and float(got[-1]) == float(out[-1]) == 1.0
    np.testing.assert_allclose(float(got[0]), float(out[3]), rtol=RTOL)
    assert float(got[1]) == float(out[4]) == D * 8
    assert int(got[2]) == int(out[5]) == 0
    want = copy.deepcopy(tm)
    load_jax_params(want, jax.tree_util.tree_map(np.asarray, out[0]),
                    jax.tree_util.tree_map(np.asarray, out[1]))
    for key, t in tm.state_dict().items():
        if t.is_floating_point():
            torch.testing.assert_close(t, want.state_dict()[key], rtol=RTOL, atol=ATOL, msg=key)


# ---------------------------------------------------------------------------
# The Trainer and the errors
# ---------------------------------------------------------------------------


def test_trainer_drives_a_graph_sharded_model(setup):
    tg, tmesh = setup["tg"], setup["tmesh"]
    labels = (tg.degree() > np.median(tg.degree())).astype(np.int32)
    model = tp.graph_sharded_sage(tg, D, hidden_dim=16, fanout=(3, 3), device="cpu")
    assert model.csr.num_shards == D
    tr = model.make_loader(np.arange(256), labels, batch_size=64, seed=0, drop_last=True)
    va = model.make_loader(np.arange(256), labels, batch_size=64, shuffle=False)
    b = next(iter(tr))
    assert b.stacked and b.packed.shape[0] == D and b.csr is None
    trainer = tpk.Trainer(model, mesh=tmesh, seed=0, prefetch_depth=0)
    hist = trainer.fit(tr, va, num_epochs=1, patience=5, verbose=False)
    assert np.isfinite(hist["train_loss"][0]) and hist["skipped_steps"] == [0]
    assert trainer.last_sampling_overflow == 0
    m0 = trainer.evaluate(va)
    assert m0["total"] == 256
    assert trainer.predict(va, prefer_fused=False).shape == (256, 2)
    # a re-planned config re-keys the cached steps and drops the stale ones
    seeds = np.random.default_rng(0).integers(0, 256, size=(2, D, 16)).astype(np.int32)
    cfg = model.plan_compaction(tmesh, seeds, 3)
    assert cfg is model.compaction and cfg != tss.CompactionConfig()
    assert trainer.evaluate(va)["total"] == 256
    assert set(trainer._gs_cache) == {(False, cfg)}
    # a config too tight for the frontier drops requests, and says so
    model.compaction = tss.CompactionConfig(alpha=0.05, rounds=1, dedup_features=False)
    trainer.train_epoch(tr)
    assert trainer.last_sampling_overflow > 0
    assert {k[1] for k in trainer._gs_cache} == {model.compaction}
    with pytest.raises(ValueError, match="not supported for graph-sharded"):
        tpk.Trainer(model, mesh=tmesh, scan_epochs=True, prefetch_depth=0).train_epoch(tr)
    wrong = tpk.Trainer(tp.graph_sharded_sage(tg, 2, hidden_dim=16, fanout=(3, 3), device="cpu"),
                        mesh=tmesh, prefetch_depth=0)
    with pytest.raises(ValueError, match="has 2 shards but the mesh axis 'data' has 4"):
        wrong.evaluate(va)
    plain = model.make_loader(np.arange(256), labels, batch_size=64, num_shards=None)
    with pytest.raises(ValueError, match="sharded DeviceSeedLoader"):
        trainer.train_epoch(plain)


def test_the_sharded_entry_points_refuse_what_they_cannot_run(setup):
    tmesh, tsg = setup["tmesh"], setup["tsg"]
    eight = tss.ShardedGraphCSR.partition(setup["tg"], 8, device="cpu")
    fwd = tp.make_graph_sharded_sampled_forward(tpk.NodeSAGE(5, 8), tmesh, (3, 3))
    with pytest.raises(ValueError, match="8 shards but mesh axis 'data' has 4"):
        fwd(eight, torch.zeros(8, 2, dtype=torch.long), torch.zeros(8, 2, dtype=torch.long))
    with pytest.raises(ValueError, match=r"stacked \[D, S\]"):
        fwd(tsg, torch.zeros(3, 2, dtype=torch.long), torch.zeros(3, 2, dtype=torch.long))
    with pytest.raises(ValueError, match="SAGE-family"):
        tp.GraphShardedSampledModel(tsg, tpk.NodeGCN(5, 8), (4, 4))
    part = tss.ShardedGraphCSR.partition_streamed(
        lambda: iter([(*setup["tg"].edge_index, setup["tg"].edge_weight)]),
        setup["tg"].node_features, 256, D, shard_range=(1, 2), device="cpu")
    with pytest.raises(ValueError, match=r"holds shards \[1, 2\)"):
        tp.shard_csr(part, tmesh)
    with pytest.raises(ValueError, match="1-D mesh"):
        tp.shard_csr(tss.ShardedGraphCSR.partition(setup["tg"], 2, device="cpu"),
                     tp.create_mesh((2, 2), ("data", "edge"), device="cpu"))
    with pytest.raises(RuntimeError, match='pass device="cpu"'):
        torch_cuda = torch.cuda.is_available
        torch.cuda.is_available = lambda: False
        try:
            tss.ShardedGraphCSR.partition(setup["tg"], D)
        finally:
            torch.cuda.is_available = torch_cuda
