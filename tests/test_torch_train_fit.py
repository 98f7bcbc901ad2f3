"""The port's graph-classification training (``train/trainer.py``,
``train/fault.py``, ``train/checkpoint.py``, ``data/prefetch.py`` and the
generator-driven ``nn.layers.Dropout``) on the CPU.

Four groups:

* **The oracle**: k = 3 steps of ``train_epoch`` against the JAX
  ``Trainer.train_epoch`` from the same weights (carried over by
  ``load_jax_params``), the same numpy-made graphs and the same unshuffled
  loader, dropout 0, for GCN and SAGE in the COO and dense layouts.  Each
  step's loss at 1e-5, its gradients at rtol 1e-4 / atol 1e-5 (against
  ``jax.grad`` of the JAX step's loss), and every parameter and running
  moment after the k steps at rtol 1e-4 / atol 1e-5 — except two, looser
  for a stated reason.  A GCN conv's bias is followed directly by masked
  BatchNorm, which removes any per-feature shift, so the loss does not
  depend on it: its gradient is float32 noise (~1e-8 here), different in
  the two frameworks, and Adam's ``g / (sqrt(v) + eps)`` turns that noise
  into steps of up to ``lr`` either way.  So the GCN conv biases are held
  at ``2·k·lr`` (6e-3; measured on the CPU: at most 8.5e-4), and, since the
  bias enters the batch mean, the GCN running means at ``momentum·lr·k·(k -
  1)`` (6e-4; measured at most 1.9e-4).  SAGE's conv biases have real
  gradients and are held at the tight tolerance.
* **The guard**: the port's counterparts of ``tests/test_fault.py``'s
  ``TestNonFiniteGuard`` and ``TestPreemption``.
* **Fit and checkpoints**: the counterparts of ``tests/test_training.py``'s
  ``TestTrainer``, ``TestCheckpoint`` and ``TestFitCheckpointResume``,
  resume bitwise with dropout 0.3.
* **Prefetch** order, errors and thread shutdown.
"""

import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import connectome_gnn_tpu as jp
import connectome_gnn_tpu_torch as tp
from connectome_gnn_tpu_torch.data.prefetch import PrefetchIterator, PrefetchLoader
from connectome_gnn_tpu_torch.models import load_jax_params
from connectome_gnn_tpu_torch.models.compat import reference_state_dict_from_params
from connectome_gnn_tpu_torch.nn.layers import Dropout
from connectome_gnn_tpu_torch.train import (
    PreemptionGuard,
    Trainer,
    reference_adam,
    restore_checkpoint,
    save_checkpoint,
)
from connectome_gnn_tpu_torch.train import fault

RTOL, ATOL = 1e-4, 1e-5
LOSS_TOL = 1e-5
K_STEPS, LR, MOMENTUM = 3, 1e-3, 0.1
#: the GCN conv-bias trap (module docstring): Adam moves a parameter by at
#: most about lr a step, in either direction on each side
GCN_BIAS_ATOL = 2 * K_STEPS * LR
GCN_RUNNING_MEAN_ATOL = MOMENTUM * LR * K_STEPS * (K_STEPS - 1)
CLASSES = {"gcn": (jp.GCNConnectome, tp.GCNConnectome),
           "sage": (jp.GraphSAGEConnectome, tp.GraphSAGEConnectome)}


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_loss_grads(jmodel, params, state, batch):
    """``jax.grad`` of the JAX train step's loss (``trainer.py:176-186``)."""

    def loss_fn(p):
        logits, _ = jmodel.apply(p, state, batch, train=True, rng=jax.random.PRNGKey(0))
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, batch.labels)
        mask = batch.label_mask.astype(jnp.float32)
        return jnp.sum(ce * mask) / jnp.maximum(jnp.sum(mask), 1.0)

    return jax.grad(loss_fn)(params)


def oracle_pair(kind, layout):
    jcls, tcls = CLASSES[kind]
    jmodel = jcls(in_channels=5, hidden_dim=32, num_layers=2, dropout=0.0)
    params, state = jmodel.init(jax.random.PRNGKey(0))
    tmodel = tcls(in_channels=5, hidden_dim=32, num_layers=2, dropout=0.0)
    load_jax_params(tmodel, numpy_tree(params), numpy_tree(state))
    jt = jp.Trainer(jmodel, params=params, state=state, prefetch_depth=0)
    tt = Trainer(tmodel, device="cpu", prefetch_depth=0)
    kw = dict(batch_size=10, shuffle=False, layout=layout)
    jl = jp.ConnectomeDataLoader(jp.generate_dataset(num_subjects=24, num_regions=20, seed=42), **kw)
    tl = tp.ConnectomeDataLoader(tp.generate_dataset(num_subjects=24, num_regions=20, seed=42), **kw)
    return jmodel, jt, tt, jl, tl


def step_tolerance(kind, name):
    if kind == "gcn" and name.startswith("convs.") and name.endswith(".bias"):
        return dict(rtol=0, atol=GCN_BIAS_ATOL)
    if kind == "gcn" and name.endswith("running_mean"):
        return dict(rtol=0, atol=GCN_RUNNING_MEAN_ATOL)
    return dict(rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("layout", ["coo", "dense"])
@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_k_steps_match_jax(kind, layout):
    jmodel, jt, tt, jl, tl = oracle_pair(kind, layout)
    jbatches, tbatches = list(jl), list(tl)
    assert len(jbatches) == K_STEPS  # 24 graphs in batches of 10: the last is partial
    sage = kind == "sage"
    for jb, tb in zip(jbatches, tbatches):
        grads = reference_state_dict_from_params(
            numpy_tree(jax_loss_grads(jmodel, jt.params, jt.state, jb)), numpy_tree(jt.state),
            sage=sage)
        want, got = jt.train_epoch([jb]), tt.train_epoch([tb])
        np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_TOL)
        for name, p in tt.model.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), grads[name], rtol=RTOL, atol=ATOL, err_msg=name)
    want = reference_state_dict_from_params(numpy_tree(jt.params), numpy_tree(jt.state), sage=sage)
    got = tt.model.state_dict()
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value, err_msg=name, **step_tolerance(kind, name))
    assert tt.optimizer.state[next(tt.model.parameters())]["step"].item() == K_STEPS


@pytest.mark.parametrize("layout", ["coo", "dense"])
def test_epoch_loss_per_graph_matches_jax(layout):
    """One epoch over a loader whose last batch is partial: the return is
    ``Σ loss·n / Σ n`` in both."""
    _, jt, tt, jl, tl = oracle_pair("sage", layout)
    np.testing.assert_allclose(tt.train_epoch(tl), jt.train_epoch(jl), rtol=0, atol=LOSS_TOL)
    assert tt.last_skipped_steps == jt.last_skipped_steps == 0


# ---------------------------------------------------------------------------
# The non-finite guard and preemption (tests/test_fault.py)
# ---------------------------------------------------------------------------


def fault_graphs(poison=False):
    graphs = tp.generate_dataset(num_subjects=40, num_regions=20, seed=7)
    if poison:
        # one bad subject: NaN features give a NaN loss AND NaN gradients
        graphs[12].node_features[:] = np.nan
    return graphs


def fault_loaders(graphs, batch_size=10):
    return (tp.ConnectomeDataLoader(graphs[:30], batch_size=batch_size, shuffle=False),
            tp.ConnectomeDataLoader(graphs[30:], batch_size=batch_size, shuffle=False))


def make_trainer(seed=0, guard=True, lr=1e-3, dropout=0.3, model_seed=0, **kw):
    model = tp.GCNConnectome(in_channels=5, hidden_dim=32, num_classes=2, num_layers=2,
                             dropout=dropout, generator=torch.Generator().manual_seed(model_seed))
    return Trainer(model, optimizer=reference_adam(lr), seed=seed, device="cpu",
                   skip_nonfinite=guard, **kw)


def everything(trainer):
    """Parameters, buffers and optimizer state, cloned, by name."""
    out = {f"model/{k}": v.clone() for k, v in trainer.model.state_dict().items()}
    for i, state in trainer.optimizer.state_dict()["state"].items():
        out.update({f"opt/{i}/{k}": v.clone() for k, v in state.items()})
    return out


def assert_bitwise_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_clean_run_bitwise_identical_with_guard():
    graphs = fault_graphs()
    on, off = make_trainer(guard=True), make_trainer(guard=False)
    h_on = on.fit(*fault_loaders(graphs), num_epochs=2, patience=10, verbose=False)
    h_off = off.fit(*fault_loaders(graphs), num_epochs=2, patience=10, verbose=False)
    assert h_on["train_loss"] == h_off["train_loss"]
    assert h_on["val_loss"] == h_off["val_loss"]
    assert h_on["skipped_steps"] == [0, 0]
    assert_bitwise_equal(everything(on), everything(off))


def test_poisoned_batch_is_skipped_and_training_survives():
    trainer = make_trainer()
    hist = trainer.fit(*fault_loaders(fault_graphs(poison=True)), num_epochs=2, patience=10,
                       verbose=False)
    assert hist["skipped_steps"] == [1, 1]  # the same bad batch each epoch
    assert all(np.isfinite(v) for v in hist["train_loss"])
    assert all(bool(torch.isfinite(v).all()) for v in everything(trainer).values()
               if v.is_floating_point())


def test_without_guard_poison_spreads():
    trainer = make_trainer(guard=False)
    trainer.fit(*fault_loaders(fault_graphs(poison=True)), num_epochs=1, patience=10,
                verbose=False)
    assert any(not bool(torch.isfinite(p).all()) for p in trainer.model.parameters())


@pytest.mark.parametrize("first", [False, True], ids=["after_a_step", "first_step"])
def test_rejected_step_is_a_noop(first):
    """Parameters, BatchNorm buffers and Adam's state — its step count
    included — keep their values bitwise; the step adds loss 0 and n 0.
    As the first step, Adam's lazily made state is left at its zeros."""
    train, _ = fault_loaders(fault_graphs(poison=True))
    batches = list(train)
    bad = batches[1]  # subject 12 lives in the second batch of 10
    assert not bool(torch.isfinite(bad.node_features).all())
    trainer = make_trainer()
    if not first:
        trainer.train_epoch([batches[0]])
    before = everything(trainer)
    loss, n, ok = trainer._train_step(bad)
    assert (float(loss), float(n), float(ok)) == (0.0, 0.0, 0.0)
    after = everything(trainer)
    if first:
        assert all(not k.startswith("opt/") for k in before)
        for k, v in after.items():
            if k.startswith("opt/"):
                assert not bool(v.any()), k
        after = {k: v for k, v in after.items() if not k.startswith("opt/")}
    else:
        step = trainer.optimizer.state[next(trainer.model.parameters())]["step"]
        assert float(step) == 1.0
    assert_bitwise_equal(before, after)
    assert trainer.train_epoch([bad]) == 0.0 and trainer.last_skipped_steps == 1


def test_all_finite_and_select():
    good = [torch.ones(3), torch.zeros(2), torch.tensor([1, 2])]
    bad = [torch.ones(3), torch.tensor([1.0, float("nan")])]
    assert bool(fault.all_finite(*good))
    assert not bool(fault.all_finite(*good, *bad))
    new = [torch.tensor([-0.0, 2.0]), torch.tensor([1, 2])]
    old = fault.snapshot(new)
    new[0].copy_(torch.tensor([1.0, float("nan")]))
    new[1].add_(5)
    born = torch.tensor([[3.0]])
    fault.select_(fault.all_finite(*new), new + [born], old)
    assert torch.equal(new[0].view(torch.int32), torch.tensor([-0.0, 2.0]).view(torch.int32))
    assert torch.equal(new[1], torch.tensor([1, 2])) and torch.equal(born, torch.zeros(1, 1))
    kept = [torch.tensor([4.0, 5.0])]
    fault.select_(torch.tensor(True), kept, old)
    assert torch.equal(kept[0], torch.tensor([4.0, 5.0]))


class _PreemptingLoader:
    """Delegating loader that raises SIGTERM while iterating a chosen
    epoch: the cloud preemption signal arriving mid-epoch."""

    def __init__(self, inner, fire_at_epoch):
        self._inner = inner
        self._fire_at = fire_at_epoch
        self._epoch = 0

    def set_epoch(self, epoch):
        self._epoch = epoch
        self._inner.set_epoch(epoch)

    def __len__(self):
        return len(self._inner)

    def __iter__(self):
        for i, batch in enumerate(self._inner):
            if i == 0 and self._epoch == self._fire_at:
                signal.raise_signal(signal.SIGTERM)
            yield batch


def test_preemption_guard_catches_and_restores():
    before = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard() as guard:
        assert not guard.triggered
        signal.raise_signal(signal.SIGTERM)
        assert guard.triggered
    assert signal.getsignal(signal.SIGTERM) is before


def shuffled_loaders(graphs=None):
    graphs = graphs or tp.generate_dataset(num_subjects=40, num_regions=20, seed=7)
    return (tp.ConnectomeDataLoader(graphs[:30], batch_size=10, shuffle=True, seed=0),
            tp.ConnectomeDataLoader(graphs[30:], batch_size=10, shuffle=False))


def test_preempted_fit_checkpoints_then_resumes_exactly(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    ref = make_trainer(seed=3)
    h_ref = ref.fit(*shuffled_loaders(), num_epochs=5, patience=10, verbose=False)

    first = make_trainer(seed=3)
    train, val = shuffled_loaders()
    h_first = first.fit(_PreemptingLoader(train, fire_at_epoch=2), val, num_epochs=5,
                        patience=10, verbose=False, checkpoint_dir=ckpt)
    # the signal came during epoch 3 (set_epoch is 0-based): that epoch
    # completes, is checkpointed, and fit returns
    assert len(h_first["train_loss"]) == 3

    second = make_trainer(seed=3)
    h_resumed = second.fit(*shuffled_loaders(), num_epochs=5, patience=10, verbose=False,
                           checkpoint_dir=ckpt, resume=True)
    assert h_resumed == h_ref
    assert_bitwise_equal(everything(second), everything(ref))


# ---------------------------------------------------------------------------
# fit, evaluate and checkpoints (tests/test_training.py)
# ---------------------------------------------------------------------------


def test_fit_returns_history():
    history = make_trainer().fit(*shuffled_loaders(), num_epochs=3, patience=10, verbose=False)
    assert set(history) == {"train_loss", "val_loss", "val_acc", "skipped_steps"}
    assert [len(v) for v in history.values()] == [3, 3, 3, 3]
    assert history["skipped_steps"] == [0, 0, 0]


def test_loss_decreases():
    history = make_trainer(seed=1, lr=5e-3).fit(*shuffled_loaders(), num_epochs=10, patience=20,
                                                 verbose=False)
    # generous slack, as the JAX package's test (reference test_training.py:35-46)
    assert history["train_loss"][-1] <= history["train_loss"][0] + 0.5


def test_evaluate_metrics():
    metrics = make_trainer().evaluate(shuffled_loaders()[1])
    assert 0.0 <= metrics["accuracy"] <= 1.0
    assert metrics["total"] == 10 and 0 <= metrics["correct"] <= 10
    assert np.isfinite(metrics["loss"])


def test_early_stopping_bounds_epochs():
    history = make_trainer(seed=2).fit(*shuffled_loaders(), num_epochs=50, patience=2,
                                       verbose=False)
    assert len(history["train_loss"]) < 50
    best = int(np.argmin(history["val_loss"]))
    assert len(history["train_loss"]) == best + 1 + 2


def test_best_weights_restored():
    """After fit, evaluate() reproduces the best recorded validation loss."""
    trainer = make_trainer(seed=3)
    train, val = shuffled_loaders()
    history = trainer.fit(train, val, num_epochs=5, patience=10, verbose=False)
    assert trainer.evaluate(val)["loss"] == min(history["val_loss"])


def test_checkpoint_roundtrip(tmp_path):
    train, val = shuffled_loaders()
    trainer = make_trainer(seed=4)
    trainer.fit(train, val, num_epochs=2, patience=10, verbose=False)
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, {"model": trainer.model.state_dict()})
    fresh = make_trainer(seed=5, model_seed=5)
    restored = restore_checkpoint(path, {"model": fresh.model.state_dict()})
    fresh.model.load_state_dict(restored["model"])
    a, b = trainer.evaluate(val), fresh.evaluate(val)
    assert a == b


def test_checkpoint_missing_leaf_and_shape_mismatch(tmp_path):
    path = str(tmp_path / "c")
    save_checkpoint(path, {"a": np.ones(3), "b": [torch.zeros(2, 2)]})
    with pytest.raises(KeyError):
        restore_checkpoint(path, {"a": np.ones(3), "c": np.ones(2)})
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(path, {"a": np.ones(4)})
    tree = restore_checkpoint(path, {"a": np.zeros(3), "b": [torch.ones(2, 2)]})
    assert np.array_equal(tree["a"], np.ones(3)) and torch.equal(tree["b"][0], torch.zeros(2, 2))
    assert [p.name for p in tmp_path.iterdir()] == ["c.npz"]  # no tmp file left behind


def test_resume_bitwise_matches_uninterrupted(tmp_path):
    """Dropout 0.3 draws from the trainer's generator, whose state is in the
    checkpoint, so the resumed run replays the same masks."""
    ckpt = str(tmp_path / "ckpt")
    ref = make_trainer(seed=3)
    hist_ref = ref.fit(*shuffled_loaders(), num_epochs=6, patience=10, verbose=False)
    make_trainer(seed=3).fit(*shuffled_loaders(), num_epochs=3, patience=10, verbose=False,
                             checkpoint_dir=ckpt)
    second = make_trainer(seed=3)
    hist_resumed = second.fit(*shuffled_loaders(), num_epochs=6, patience=10, verbose=False,
                              checkpoint_dir=ckpt, resume=True)
    assert hist_resumed == hist_ref
    assert_bitwise_equal(everything(second), everything(ref))
    assert torch.equal(second.generator.get_state(), ref.generator.get_state())


def test_resume_with_no_checkpoint_starts_fresh(tmp_path):
    hist = make_trainer(seed=1).fit(*shuffled_loaders(), num_epochs=2, patience=10, verbose=False,
                                    checkpoint_dir=str(tmp_path / "none"), resume=True)
    assert len(hist["train_loss"]) == 2


def test_checkpoint_every_and_final_write(tmp_path):
    ckpt = str(tmp_path / "ck2")
    make_trainer(seed=2).fit(*shuffled_loaders(), num_epochs=5, patience=10, verbose=False,
                             checkpoint_dir=ckpt, checkpoint_every=2)
    meta = make_trainer(seed=2)._restore_fit_checkpoint(ckpt)
    assert meta["epoch"] == 5  # the final epoch is always checkpointed
    assert len(meta["history"]["train_loss"]) == 5
    assert not meta["stopped_early"]


def test_resume_after_early_stop_trains_no_extra_epochs(tmp_path):
    ckpt = str(tmp_path / "ck3")
    trainer = make_trainer(seed=4)
    hist = trainer.fit(*shuffled_loaders(), num_epochs=50, patience=1, verbose=False,
                       checkpoint_dir=ckpt)
    stopped_at = len(hist["train_loss"])
    assert stopped_at < 50
    again = make_trainer(seed=4)
    hist2 = again.fit(*shuffled_loaders(), num_epochs=50, patience=1, verbose=False,
                      checkpoint_dir=ckpt, resume=True)
    assert len(hist2["train_loss"]) == stopped_at
    assert_bitwise_equal(
        {k: v for k, v in everything(again).items() if k.startswith("model/")},
        {k: v for k, v in everything(trainer).items() if k.startswith("model/")})


def test_prefetch_changes_no_value():
    a, b = make_trainer(prefetch_depth=0), make_trainer(prefetch_depth=3)
    ha = a.fit(*shuffled_loaders(), num_epochs=2, patience=10, verbose=False)
    hb = b.fit(*shuffled_loaders(), num_epochs=2, patience=10, verbose=False)
    assert ha == hb
    assert_bitwise_equal(everything(a), everything(b))


def test_dropout_draws_from_the_trainers_generator():
    x = torch.ones(4, 1000)
    drop = Dropout(0.3)
    assert drop.eval()(x) is x and Dropout(0.0).train()(x) is x
    trainer = make_trainer(seed=11)
    drops = [m for m in trainer.model.modules() if isinstance(m, Dropout)]
    assert len(drops) == 2 and all(m.generator is trainer.generator for m in drops)
    state = trainer.generator.get_state()
    y1 = drops[0].train()(x)
    trainer.generator.set_state(state)
    y2 = drops[0](x)
    assert torch.equal(y1, y2)
    assert torch.equal(torch.unique(y1), torch.tensor([0.0, 1.0]) / 0.7)
    assert abs(float((y1 == 0).float().mean()) - 0.3) < 0.02
    with pytest.raises(ValueError):
        Dropout(1.0)


# ---------------------------------------------------------------------------
# Prefetching (data/prefetch.py)
# ---------------------------------------------------------------------------


def test_prefetch_keeps_order():
    assert list(PrefetchIterator(range(100), depth=3)) == list(range(100))
    loader = PrefetchLoader(list(range(10)), depth=1)
    assert len(loader) == 10 and list(loader) == list(loader) == list(range(10))
    with pytest.raises(ValueError):
        PrefetchIterator([], depth=0)


def test_prefetch_raises_the_producers_error():
    def source():
        yield 1
        yield 2
        raise RuntimeError("collate failed")

    it = PrefetchIterator(source(), depth=2)
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(RuntimeError, match="collate failed"):
        next(it)


def test_partial_consumption_stops_the_thread():
    produced = []

    def source():
        for i in range(1000):
            produced.append(i)
            yield i

    it = PrefetchIterator(source(), depth=2)
    assert next(it) == 0
    it.close()
    it._thread.join(timeout=5.0)
    assert not it._thread.is_alive()
    time.sleep(0.3)
    assert len(produced) < 10
