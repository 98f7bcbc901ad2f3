"""Sampled data parallelism and graph-sharded sampling on the card against
the port on the CPU, at small size (``chip_smoke.py`` phases 36-38 run the
same checks at full width).

Every test here needs a CUDA card and skips without one.  The card's mesh is
one rank of an NCCL group of size 1 holding 4 shards; the CPU's is a mesh of
4 shards in one process.  The machine with the card has no JAX, and
``tests/conftest.py`` imports it, so run them there without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sampled_parallel_cuda.py

This file imports no JAX.  Bitwise: the graph-sharded sample with both
exchanges (integer hashes, sorts, gathers, scatters and the NCCL
exchanges of exact values) and its overflow counts.  The captured mesh
epoch (one CUDA graph a step, the NCCL sync-BatchNorm and gradient
all-reduces inside it) against the stepwise mesh epoch on the card, with
``tests/test_torch_sampled_cuda.py``'s tolerances: SAGE in the multiset mode
bitwise, dropout's generators included; the GCN within 1e-4 / 1e-5 but for
its conv biases (noise gradients); and the mesh's counters grown by the
captured step's counts a replay.
"""

import copy
import re
import tempfile

import numpy as np
import pytest
import torch

import connectome_gnn_tpu_torch as tp
import connectome_gnn_tpu_torch.data as td
from connectome_gnn_tpu_torch import parallel

pytestmark = pytest.mark.requires_cuda

RTOL, ATOL = 1e-4, 1e-5
D = 4
FANOUT = (4, 3)


@pytest.fixture(scope="module")
def meshes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cuda = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        parallel.initialize_distributed(f"file://{tmp}/rendezvous", 1, 0, device=cuda)
        try:
            yield parallel.create_mesh((D,), ("data",), device=cuda), parallel.Mesh(
                (D,), ("data",), "cpu")
        finally:
            parallel.shutdown_distributed()


@pytest.fixture(scope="module")
def graph():
    g = tp.generate_spatial_graph(4096, degree=8, band=64, shortcut_frac=0.1, seed=0)
    return g, (g.node_features[:, 0] > 0).astype(np.int32)


@pytest.mark.parametrize("compaction", [None, parallel.CompactionConfig(alpha=1.0, rounds=2),
                                        parallel.CompactionConfig(alpha=0.2, rounds=1)])
def test_graph_sharded_sample_is_the_cpus(meshes, graph, compaction):
    card, cpu = meshes
    g, _ = graph
    csr = parallel.ShardedGraphCSR.partition(g, D, device="cpu")
    seeds = torch.from_numpy(np.random.default_rng(0).choice(g.num_nodes, (D, 32), replace=False))
    seeds[-1, -3:] = -1
    keys = torch.from_numpy(parallel.sharded_sampling.probe_key_words(9, 1, D)[0])
    got, ovf = parallel.sharded_device_sample_with_stats(parallel.shard_csr(csr, card), seeds, keys,
                                                         FANOUT, card, compaction=compaction)
    want, ovf_cpu = parallel.sharded_device_sample_with_stats(csr, seeds, keys, FANOUT, cpu,
                                                              compaction=compaction)
    assert ovf.cpu().tolist() == ovf_cpu.tolist()
    for a, b in zip(got, want):
        for name in ("node_ids", "node_mask", "node_features", "senders", "receivers", "edge_weight"):
            assert getattr(a, name).is_cuda and torch.equal(getattr(a, name).cpu(), getattr(b, name)), name
        for x, y in zip(a.hop_blocks, b.hop_blocks):
            assert torch.equal(x.senders.cpu(), y.senders) and torch.equal(x.weights.cpu(), y.weights)


def trainer_state(trainer) -> dict:
    """Parameters, buffers, Adam state and the last step's gradients (the
    captured step's buffers hold the warm-up's until a replay)."""
    state = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}
    for name, p in trainer.model.inner.named_parameters():
        state[f"grad {name}"] = p.grad.detach().cpu()
        for k, v in trainer.optimizer.state[p].items():
            state[f"adam {name} {k}"] = v.detach().cpu()
    return state


def tolerance(kind, name, steps) -> dict:
    """``tests/test_torch_sampled_cuda.py``'s: a GCN conv's bias and the
    running means it feeds at 2·k·lr and momentum·lr·k·(k-1) after k steps;
    SAGE multiset bitwise."""
    if kind == "gcn" and re.fullmatch(r"convs\.\d+\.bias", name):
        return dict(rtol=0.0, atol=2 * steps * 1e-3)
    if kind == "gcn" and re.fullmatch(r"batch_norms\.\d+\.running_mean", name):
        return dict(rtol=0.0, atol=0.1 * 1e-3 * steps * (steps - 1))
    if kind == "gcn":
        return dict(rtol=RTOL, atol=ATOL)
    return dict(rtol=0.0, atol=0.0)


@pytest.mark.parametrize("kind,dropout", [("gcn", 0.0), ("sage", 0.3)])
def test_captured_mesh_epoch_is_stepwise(meshes, graph, kind, dropout):
    card, _ = meshes
    g, labels = graph
    if kind == "gcn":
        base = td.device_sampled_gcn(g, hidden_dim=16, fanout=FANOUT, dropout=dropout, device=card.device)
    else:
        base = td.device_sampled_sage(g, hidden_dim=16, fanout=FANOUT, dropout=dropout, dedup=False,
                                      device=card.device)
    runs = []
    for scan in (False, True):
        model = copy.deepcopy(base)
        loader = model.make_loader(np.arange(1024), labels[:1024], batch_size=128, seed=3,
                                   num_shards=D, drop_last=True)
        trainer = tp.Trainer(model, seed=0, mesh=card, scan_epochs=scan)
        card.bytes_moved.clear()
        losses = [trainer.train_epoch(loader) for _ in range(2)]
        runs.append((losses, trainer_state(trainer), trainer, dict(card.bytes_moved)))
    (l1, s1, _, moved1), (l2, s2, scanned, moved2) = runs
    assert len(scanned._captured) == 1
    assert moved2 == moved1  # the replays counted as the stepwise steps are
    # one epoch of one row: the warm-up step alone, its gradients kept
    one_row = copy.deepcopy(base)
    trainer = tp.Trainer(one_row, seed=0, mesh=card, scan_epochs=True)
    trainer.train_epoch(one_row.make_loader(np.arange(128), labels[:128], batch_size=128,
                                            num_shards=D))
    assert sum(float(p.grad.abs().sum()) for p in one_row.inner.parameters()) > 0
    np.testing.assert_allclose(l2, l1, rtol=1e-5)
    for name, want in s1.items():
        torch.testing.assert_close(s2[name], want, **tolerance(kind, name, 16), msg=name)
