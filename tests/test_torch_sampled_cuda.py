"""Sampled node training on the card against the port on the CPU, at small
size (``chip_smoke.py`` phases 29-31 run the same checks at full width).

Every test here needs a CUDA card and skips without one.  The machine with
the card has no JAX, and ``tests/conftest.py`` imports it, so run them
there without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sampled_cuda.py

This file imports no JAX.  Bitwise: the fused loader's batches, the draws
and ``device_sample`` in both modes (integer hashes, sorts, gathers and
scatters of exact values).  Gates: eval logits rtol 1e-4 / atol 1e-5, a
train step's loss rtol 1e-5 and gradients rtol 1e-4 / atol 1e-5 (the
card's ``index_add_`` sums in another order).  A scanned epoch (one
captured CUDA graph a step) against the stepwise epoch on the card: the
loss, parameters, BatchNorm buffers and Adam state within 1e-4 / 1e-5
(atomic adds make neither path of the GCN replay bitwise on the card), but
for the GCN conv biases and the running means they feed (noise gradients,
``tolerance``); SAGE in the multiset mode, which adds by slices, not
atomics, bitwise, dropout's generator included.
"""

import copy
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import connectome_gnn_tpu_torch as tp
import connectome_gnn_tpu_torch.data as td

pytestmark = pytest.mark.requires_cuda

RTOL, ATOL = 1e-4, 1e-5
FANOUT = (4, 3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def graph():
    g = tp.generate_spatial_graph(4096, degree=8, band=64, shortcut_frac=0.1, seed=0)
    labels = (g.node_features[:, 0] > 0).astype(np.int32)
    return g, labels


def test_fused_loader_batches_are_the_cpus(cuda, graph):
    g, labels = graph
    kw = dict(batch_size=64, fanout=FANOUT, seed=2)
    for on_card, on_cpu in zip(td.SampledNodeLoader(g, labels, device=cuda, **kw),
                               td.SampledNodeLoader(g, labels, device="cpu", **kw)):
        for name in ("node_features", "senders", "receivers", "edge_weight", "node_mask",
                     "labels", "label_mask", "seed_mask", "node_ids"):
            got = getattr(on_card, name)
            assert got.is_cuda, name
            assert torch.equal(got.cpu(), getattr(on_cpu, name)), name


@pytest.mark.parametrize("dedup", [True, False])
def test_device_sample_is_the_cpus(cuda, graph, dedup):
    g, _ = graph
    csr_card = td.DeviceGraphCSR.from_graph(g, device=cuda)
    csr_cpu = td.DeviceGraphCSR.from_graph(g, device="cpu")
    seeds = np.random.default_rng(0).choice(g.num_nodes, 64, replace=False)
    seeds[-3:] = -1
    row = td.make_seed_batch(seeds[seeds >= 0], None, 1234, 64, device="cpu")
    got = td.device_sample(csr_card, row.seeds.to(cuda), row.key_words.to(cuda), FANOUT, dedup=dedup)
    want = td.device_sample(csr_cpu, row.seeds, row.key_words, FANOUT, dedup=dedup)
    for name in ("node_ids", "node_mask", "node_features", "senders", "receivers", "edge_weight"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name
    for a, b in zip(got.hop_blocks, want.hop_blocks):
        assert torch.equal(a.senders.cpu(), b.senders) and torch.equal(a.weights.cpu(), b.weights)


def sampled_models(g, device, kind, dedup=True):
    make = td.device_sampled_gcn if kind == "gcn" else td.device_sampled_sage
    kw = {} if kind == "gcn" else dict(dedup=dedup)
    return make(g, hidden_dim=16, fanout=FANOUT, device=device, **kw)


@pytest.mark.parametrize("kind,dedup", [("gcn", True), ("sage", True), ("sage", False)])
def test_logits_and_a_step_match_the_cpu(cuda, graph, kind, dedup):
    g, labels = graph
    on_cpu = sampled_models(g, "cpu", kind, dedup)
    on_card = sampled_models(g, cuda, kind, dedup)
    on_card.load_state_dict(on_cpu.state_dict())
    row = td.make_seed_batch(np.arange(0, 4096, 50)[:64], labels, 77, 64, device="cpu")
    for train in (False, True):
        outs = []
        for model, batch in ((on_cpu, row), (on_card, row.to(cuda))):
            model.train(train)
            model.zero_grad()
            logits = model(batch)
            loss = F.cross_entropy(logits, batch.labels)
            if train:
                loss.backward()
            outs.append((logits.detach().cpu(), loss.item(),
                         {k: p.grad.cpu() for k, p in model.inner.named_parameters()} if train else {}))
        (lc, sc, gc), (lg, sg, gg) = outs
        torch.testing.assert_close(lg, lc, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(sg, sc, rtol=1e-5)
        for name in gc:
            torch.testing.assert_close(gg[name], gc[name], rtol=RTOL, atol=ATOL, msg=name)


def trainer_state(trainer) -> dict:
    """Parameters, buffers and Adam state by name, on the CPU."""
    state = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}
    for name, p in trainer.model.inner.named_parameters():
        for k, v in trainer.optimizer.state[p].items():
            state[f"adam {name} {k}"] = v.detach().cpu()
    return state


def tolerance(kind, name, steps) -> dict:
    """A GCN conv's bias feeds BatchNorm, which cancels it: its gradient is
    float32 noise that Adam turns into steps of up to lr, so the bias and
    the running means it feeds are held to 2·k·lr and momentum·lr·k·(k-1)
    after k steps (``tests/test_torch_train_fit.py``); the rest to the gate."""
    if kind == "gcn" and re.fullmatch(r"convs\.\d+\.bias", name):
        return dict(rtol=0.0, atol=2 * steps * 1e-3)
    if kind == "gcn" and re.fullmatch(r"batch_norms\.\d+\.running_mean", name):
        return dict(rtol=0.0, atol=0.1 * 1e-3 * steps * (steps - 1))
    if kind == "gcn":
        return dict(rtol=RTOL, atol=ATOL)
    return dict(rtol=0.0, atol=0.0)  # SAGE multiset adds nothing by atomics


@pytest.mark.parametrize("kind,dedup,dropout", [("gcn", True, 0.0), ("sage", False, 0.3)])
def test_scan_epochs_replays_a_captured_step(cuda, graph, kind, dedup, dropout):
    g, labels = graph
    base = sampled_models(g, cuda, kind, dedup)
    base.inner.dropout.p = dropout
    runs = []
    for scan in (False, True):
        model = copy.deepcopy(base)
        loader = model.make_loader(np.arange(1024), labels[:1024], batch_size=128, seed=3,
                                   drop_last=True)
        trainer = tp.Trainer(model, seed=0, scan_epochs=scan)
        losses = [trainer.train_epoch(loader) for _ in range(2)]
        runs.append((losses, trainer_state(trainer), trainer))
    (l1, s1, _), (l2, s2, scanned) = runs
    assert len(scanned._captured) == 1  # one graph, captured once, replayed in both epochs
    np.testing.assert_allclose(l2, l1, rtol=1e-5)
    assert s2.keys() == s1.keys()
    for name, want in s1.items():
        torch.testing.assert_close(s2[name], want, **tolerance(kind, name, 16), msg=name)


def test_trainer_refuses_a_csr_left_on_the_cpu(cuda, graph):
    g, _ = graph
    model = sampled_models(g, "cpu", "gcn")
    with pytest.raises(ValueError, match="CSR does not move"):
        tp.Trainer(model, device=cuda)
