"""The port's mesh, data parallelism and the Trainer's mesh mode against
the JAX package on the CPU (8 virtual devices from ``tests/conftest.py``).

JAX runs one shard per virtual device; the port runs one process holding
every shard of the mesh as a leading tensor axis.  Stacked batches are
bitwise JAX's.  Steps run at dropout 0 (JAX's dropout streams cannot be
reproduced) with JAX's weights carried over: one step's gradients (an
SGD step at lr 1, whose update is the gradient) at rtol 1e-4 / atol 1e-5,
and fits with Adam, where a GCN conv's bias, cancelled by BatchNorm, moves
on float32 noise gradients: it is held to 2·k·lr after k steps and the
running means it feeds to momentum·lr·k·(k−1) (``ROADMAP.md`` Queue 3).
"""

import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

import connectome_gnn_tpu.data as jd
import connectome_gnn_tpu.parallel as jp
from connectome_gnn_tpu.models import GCNConnectome as JGCN
from connectome_gnn_tpu.models import GraphSAGEConnectome as JSAGE
from connectome_gnn_tpu.train import Trainer as JTrainer
from connectome_gnn_tpu.train import reference_adam as jadam

import connectome_gnn_tpu_torch as tpk
import connectome_gnn_tpu_torch.data as td
import connectome_gnn_tpu_torch.parallel as tp
from connectome_gnn_tpu_torch.data import device_sampling as tds
from connectome_gnn_tpu_torch.models.compat import (
    load_jax_params,
    reference_state_dict_from_params,
)

D = 8
RTOL, ATOL = 1e-4, 1e-5
LR, MOMENTUM = 1e-3, 0.1
FAMILIES = {"gcn": (JGCN, tpk.GCNConnectome), "sage": (JSAGE, tpk.GraphSAGEConnectome)}


@pytest.fixture(scope="module")
def dataset():
    return (jd.generate_dataset(num_subjects=24, num_regions=20, seed=9),
            td.generate_dataset(num_subjects=24, num_regions=20, seed=9))


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def tensor_fields(batch) -> dict:
    return {f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)
            if isinstance(getattr(batch, f.name), torch.Tensor)}


def assert_batches_equal(jbatch, tbatch):
    assert jbatch.num_graphs == tbatch.num_graphs
    for name, t in tensor_fields(tbatch).items():
        np.testing.assert_array_equal(np.asarray(getattr(jbatch, name)), t.numpy(), err_msg=name)


def port_model(kind, jparams, jstate, **kw):
    model = FAMILIES[kind][1](in_channels=5, hidden_dim=16, num_layers=2, dropout=0.0, **kw)
    load_jax_params(model, numpy_tree(jparams), numpy_tree(jstate))
    return model


def jax_state_dict(params, state, kind):
    return reference_state_dict_from_params(numpy_tree(params), numpy_tree(state),
                                            sage=kind == "sage")


def trap_atol(name: str, kind: str, steps: int) -> float:
    """The GCN conv bias's and its running means' noise budgets."""
    if kind == "gcn" and name.startswith("convs.") and name.endswith(".bias"):
        return 2 * steps * LR
    if kind == "gcn" and name.endswith("running_mean"):
        return MOMENTUM * LR * steps * (steps - 1)
    return ATOL


# ---------------------------------------------------------------------------
# The sharded loader
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["coo", "dense"])
def test_sharded_loader_stacks_bitwise(dataset, layout):
    jg, tg = dataset
    jl = jd.ConnectomeDataLoader(jg, batch_size=16, shuffle=True, seed=3, num_shards=D,
                                 layout=layout)
    tl = td.ConnectomeDataLoader(tg, batch_size=16, shuffle=True, seed=3, num_shards=D,
                                 layout=layout)
    jl.set_epoch(1)
    tl.set_epoch(1)
    batches = list(zip(jl, tl))
    assert len(batches) == 2 and batches[0][1].label_mask.shape == (D, 2)
    for jb, tb in batches:
        assert_batches_equal(jb, tb)


def test_process_shards_tile_the_global_stack(dataset):
    jg, tg = dataset
    full = next(iter(td.ConnectomeDataLoader(tg[:16], batch_size=16, shuffle=False,
                                             num_shards=D)))
    for p in range(4):
        kw = dict(batch_size=16, shuffle=False, num_shards=D, process_index=p, process_count=4)
        part = next(iter(td.ConnectomeDataLoader(tg[:16], **kw)))
        assert_batches_equal(next(iter(jd.ConnectomeDataLoader(jg[:16], **kw))), part)
        for name, t in tensor_fields(part).items():
            assert t.shape[0] == 2
            assert torch.equal(t, getattr(full, name)[2 * p : 2 * p + 2]), name


def test_shuffle_agrees_across_processes(dataset):
    _, tg = dataset
    full = td.ConnectomeDataLoader(tg[:16], batch_size=8, shuffle=True, seed=3, num_shards=4)
    part = td.ConnectomeDataLoader(tg[:16], batch_size=8, shuffle=True, seed=3, num_shards=4,
                                   process_index=1, process_count=2)
    full.set_epoch(2)
    part.set_epoch(2)
    for fb, pb in zip(full, part):
        for name, t in tensor_fields(pb).items():
            assert torch.equal(getattr(fb, name)[2:4], t), name


def test_loader_validation_errors(dataset):
    _, tg = dataset
    with pytest.raises(ValueError, match="divisible"):
        td.ConnectomeDataLoader(tg, batch_size=10, num_shards=4)
    with pytest.raises(ValueError, match="together"):
        td.ConnectomeDataLoader(tg, num_shards=4, process_index=0)
    with pytest.raises(ValueError, match="requires num_shards"):
        td.ConnectomeDataLoader(tg, process_index=0, process_count=2)
    with pytest.raises(ValueError, match="divisible"):
        td.ConnectomeDataLoader(tg, batch_size=4, num_shards=4, process_index=0, process_count=3)
    with pytest.raises(ValueError, match="out of range"):
        td.ConnectomeDataLoader(tg, batch_size=4, num_shards=4, process_index=2,
                                process_count=2)


# ---------------------------------------------------------------------------
# The data-parallel step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_dp_step_gradients_match_jax(dataset, kind):
    """Two SGD(lr 1) steps over the epoch's two batches, the second ragged
    (8 real graphs in 16 slots: shards 4-7 empty): the parameters after
    each are the gradients' sums, held at 1e-4 / 1e-5."""
    jg, tg = dataset
    jl = jd.ConnectomeDataLoader(jg, batch_size=16, shuffle=False, num_shards=D)
    tl = td.ConnectomeDataLoader(tg, batch_size=16, shuffle=False, num_shards=D)
    jmodel = FAMILIES[kind][0](in_channels=5, hidden_dim=16, num_layers=2, dropout=0.0)
    params, state = jmodel.init(jax.random.PRNGKey(0))
    model = port_model(kind, params, state)
    mesh_j = jp.create_mesh()
    mesh = tp.create_mesh((D,), device="cpu")
    opt = optax.sgd(1.0)
    jstep = jp.make_dp_train_step(jmodel, opt, mesh_j)
    step = tp.make_dp_train_step(model, torch.optim.SGD(model.parameters(), lr=1.0), mesh)
    opt_state = opt.init(params)
    for jb, tb in zip(jl, tl):
        params, state, opt_state, jloss, jn = jstep(params, state, opt_state,
                                                    jax.random.PRNGKey(1), jb)
        loss, n = step(mesh.place(tb))
        assert float(n) == float(jn)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        want = jax_state_dict(params, state, kind)
        for name, t in model.state_dict().items():
            if name in want:
                np.testing.assert_allclose(t.numpy(), want[name], rtol=RTOL, atol=ATOL,
                                           err_msg=name)
    assert float(n) == 8.0


def test_dp_step_is_one_device_at_the_global_batch(dataset):
    """The DP step's reduced gradients are the single-device gradients of
    the global batch, the ragged one too, and the guard on the global
    verdict is the identity on a finite step."""
    _, tg = dataset
    sharded = list(td.ConnectomeDataLoader(tg, batch_size=16, shuffle=False, num_shards=D))
    whole = list(td.ConnectomeDataLoader(tg, batch_size=16, shuffle=False))
    dp_model = tpk.GCNConnectome(5, 16, num_layers=2, dropout=0.0)
    one_model = tpk.GCNConnectome(5, 16, num_layers=2, dropout=0.0)
    mesh = tp.create_mesh((D,), device="cpu")
    step = tp.make_dp_train_step(dp_model, torch.optim.SGD(dp_model.parameters(), lr=0.0), mesh,
                                 guard=True)
    for sb, wb in zip(sharded, whole):
        loss, n, ok = step(mesh.place(sb))
        assert float(ok) == 1.0
        one_model.zero_grad()
        logits = one_model.train()(wb)
        ce = torch.nn.functional.cross_entropy(logits, wb.labels, reduction="none")
        m = wb.label_mask.float()
        want = (ce * m).sum() / m.sum()
        want.backward()
        np.testing.assert_allclose(float(loss), float(want.detach()), rtol=1e-6)
        for (name, p), q in zip(dp_model.named_parameters(), one_model.parameters()):
            torch.testing.assert_close(p.grad, q.grad, rtol=RTOL, atol=1e-7, msg=name)


def test_dp_eval_with_a_ragged_final_batch(dataset):
    """8 graphs at batch 16 over 8 shards: half the shards hold none; the
    sums count exactly the real graphs and equal JAX's eval step's."""
    jg, tg = dataset
    jmodel = JGCN(in_channels=5, hidden_dim=16, num_layers=2)
    params, state = jmodel.init(jax.random.PRNGKey(2))
    model = port_model("gcn", params, state)
    mesh = tp.create_mesh((D,), device="cpu")
    jb = next(iter(jd.ConnectomeDataLoader(jg[16:], batch_size=16, shuffle=False, num_shards=D)))
    tb = next(iter(td.ConnectomeDataLoader(tg[16:], batch_size=16, shuffle=False, num_shards=D)))
    want = jp.make_dp_eval_step(jmodel, jp.create_mesh())(params, state, jb)
    got = tp.make_dp_eval_step(model, mesh)(mesh.place(tb))
    np.testing.assert_allclose([float(g) for g in got], [float(w) for w in want], rtol=1e-5)
    assert float(got[2]) == 8.0
    assert tpk.Trainer(model, mesh=mesh).evaluate(
        td.ConnectomeDataLoader(tg[16:], batch_size=16, shuffle=False, num_shards=D))["total"] == 8


@pytest.mark.parametrize("kind,layout", [("gcn", "coo"), ("sage", "dense")])
def test_mesh_trainer_matches_jax(dataset, kind, layout):
    """Three epochs of ``Trainer(mesh=...).fit`` against JAX's mesh-mode
    Trainer (2 steps an epoch, the second batch ragged in validation), then
    ``evaluate`` and ``predict`` on JAX's final weights."""
    jg, tg = dataset

    def loaders(pkg, graphs):
        return (pkg.ConnectomeDataLoader(graphs[:16], batch_size=8, shuffle=True, seed=0,
                                         num_shards=D, layout=layout),
                pkg.ConnectomeDataLoader(graphs[16:], batch_size=16, shuffle=False,
                                         num_shards=D, layout=layout))

    jt = JTrainer(FAMILIES[kind][0](in_channels=5, hidden_dim=16, num_layers=2, dropout=0.0),
                  optimizer=jadam(LR), seed=0, mesh=jp.create_mesh())
    model = port_model(kind, jt.params, jt.state)
    mesh = tp.create_mesh((D,), device="cpu")
    trainer = tpk.Trainer(model, seed=0, mesh=mesh, prefetch_depth=0)
    jh = jt.fit(*loaders(jd, jg), num_epochs=3, patience=10, verbose=False)
    th = trainer.fit(*loaders(td, tg), num_epochs=3, patience=10, verbose=False)
    np.testing.assert_allclose(th["train_loss"], jh["train_loss"], rtol=RTOL, atol=ATOL)
    # the trap's bias and running-mean moves shift eval-mode logits: the
    # GCN's validation loss moved 4e-5 on this data
    np.testing.assert_allclose(th["val_loss"], jh["val_loss"], rtol=RTOL,
                               atol=1e-3 if kind == "gcn" else ATOL)
    assert th["skipped_steps"] == [0, 0, 0]
    want = jax_state_dict(jt.params, jt.state, kind)
    for name, t in trainer.model.state_dict().items():
        if name in want:
            np.testing.assert_allclose(t.numpy(), want[name], rtol=RTOL,
                                       atol=trap_atol(name, kind, steps=6), err_msg=name)
    # evaluate and predict on identical weights
    load_jax_params(trainer.model, numpy_tree(jt.params), numpy_tree(jt.state))
    val = loaders(td, tg)[1]
    jv, tv = jt.evaluate(loaders(jd, jg)[1]), trainer.evaluate(val)
    assert tv["total"] == jv["total"] == 8 and tv["correct"] == jv["correct"]
    np.testing.assert_allclose(tv["loss"], jv["loss"], rtol=1e-5)
    got = trainer.predict(val, prefer_fused=False)
    np.testing.assert_allclose(got, jt.predict(loaders(jd, jg)[1], prefer_fused=False),
                               rtol=RTOL, atol=ATOL)
    assert got.shape == (8, 2)
    np.testing.assert_allclose(trainer.predict(val), got, rtol=RTOL, atol=ATOL)


def test_mesh_guard_rejects_a_nonfinite_shard(dataset):
    """A NaN in one shard's features poisons the global step: every shard
    keeps its old weights, bitwise, and the step counts as skipped."""
    _, tg = dataset
    mesh = tp.create_mesh((D,), device="cpu")
    trainer = tpk.Trainer(tpk.GCNConnectome(5, 16, num_layers=2, dropout=0.0), mesh=mesh,
                          prefetch_depth=0)
    batch = next(iter(td.ConnectomeDataLoader(tg[:16], batch_size=16, shuffle=False,
                                              num_shards=D)))
    batch.node_features[3, 0, 0] = float("nan")
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    loss, n, ok = trainer._train_step(batch)
    assert float(ok) == 0.0 and float(loss) == 0.0 and float(n) == 0.0
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_mesh_mode_refuses_what_slice_e3_owns():
    mesh = tp.create_mesh((2,), device="cpu")
    with pytest.raises(NotImplementedError, match="E3"):
        tpk.Trainer(tpk.NodeGCN(5, 8), mesh=mesh, scan_epochs=True)
    trainer = tpk.Trainer(tpk.NodeGCN(5, 8), mesh=mesh, prefetch_depth=0)
    seeds = tds.make_seed_batch(np.arange(4), np.zeros(16, np.int32), 7, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="E3"):
        trainer.train_epoch([seeds])
    with pytest.raises(ValueError, match="not the mesh's device"):
        tpk.Trainer(tpk.NodeGCN(5, 8), mesh=mesh, device="meta")


# ---------------------------------------------------------------------------
# The mesh and its collectives
# ---------------------------------------------------------------------------


def test_mesh_collectives_and_their_backward():
    """On a (data 2 × edge 3) mesh: the shift is a chain (zeros at its
    ends, never across subjects), the all-to-all a transpose within each
    group, the psum and all-gather over every shard; each backward is
    checked by ``gradcheck`` in float64."""
    mesh = tp.create_mesh((2, 3), ("data", "edge"), device="cpu")
    x = torch.arange(6.0, dtype=torch.float64)[:, None].repeat(1, 2)
    right = mesh.shift(x, "edge", 1)
    assert right[:, 0].tolist() == [0, 0, 1, 0, 3, 4]
    assert mesh.shift(x, "edge", -1)[:, 0].tolist() == [1, 2, 0, 4, 5, 0]
    assert mesh.shift(x, "data", 1)[:, 0].tolist() == [0, 0, 0, 0, 1, 2]
    blocks = torch.arange(18.0, dtype=torch.float64).view(6, 3)  # shard g, block i = 3g + i
    got = mesh.all_to_all(blocks, "edge")
    for g in range(6):
        base = g - g % 3
        assert got[g].tolist() == [blocks[base + j, g % 3].item() for j in range(3)]
    assert mesh.psum(x).tolist() == [15.0, 15.0]
    assert torch.equal(mesh.all_gather(x), x)
    y = torch.randn(6, 3, 2, dtype=torch.float64, requires_grad=True)
    for fn in (lambda t: mesh.shift(t, "edge", 1), lambda t: mesh.shift(t, "edge", -1),
               lambda t: mesh.all_to_all(t, "edge"), mesh.psum, mesh.all_gather):
        assert torch.autograd.gradcheck(fn, (y,))
    assert mesh.bytes_moved["shift"] > 0 and mesh.bytes_moved["all_to_all (backward)"] > 0


def test_mesh_backend_follows_the_device(monkeypatch):
    mesh = tp.create_mesh((4,), device="cpu")
    assert mesh.group is None and (mesh.lo, mesh.hi, mesh.local_shards) == (0, 4, 4)
    with pytest.raises(ValueError, match="neither"):
        mesh.place(torch.zeros(3, 2))
    monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        tp.create_mesh((4,), device="cuda")
    with pytest.raises(RuntimeError, match="NCCL"):
        tp.initialize_distributed("file:///nonexistent", 2, 0, device="cuda")
    assert (tp.process_count(), tp.process_index(), tp.local_shard_range(8)) == (1, 0, (0, 8))


def test_dryrun_multichip_on_the_cpu(capsys):
    from connectome_gnn_tpu_torch.entry import dryrun_multichip

    dryrun_multichip(4, device="cpu")
    out = capsys.readouterr().out
    assert "dryrun_multichip(4): ok" in out and "2-D (2x2 data x edge): ok" in out
    assert "slice E3" in out


def test_mesh_fit_resumes_bitwise(dataset, tmp_path):
    """A mesh-mode fit stopped after 2 epochs and resumed to 3 equals an
    uninterrupted 3-epoch fit bitwise, dropout's per-shard generators
    included (dropout 0.3)."""
    _, tg = dataset
    mesh = tp.create_mesh((4,), device="cpu")

    def run(epochs, resume):
        model = tpk.GCNConnectome(5, 16, num_layers=2, dropout=0.3,
                                  generator=torch.Generator().manual_seed(1))
        trainer = tpk.Trainer(model, seed=3, mesh=mesh, prefetch_depth=0)
        train = td.ConnectomeDataLoader(tg[:16], batch_size=8, shuffle=True, seed=0, num_shards=4)
        val = td.ConnectomeDataLoader(tg[16:], batch_size=8, shuffle=False, num_shards=4)
        hist = trainer.fit(train, val, num_epochs=epochs, patience=10, verbose=False,
                           checkpoint_dir=str(tmp_path / "ckpt") if resume is not None else None,
                           resume=bool(resume))
        return hist, trainer.model.state_dict()

    want_hist, want = run(3, None)
    run(2, False)
    hist, got = run(3, True)
    assert hist["train_loss"] == want_hist["train_loss"]
    for name, t in got.items():
        assert torch.equal(t, want[name]), name
