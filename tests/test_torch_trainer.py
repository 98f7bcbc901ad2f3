"""The port's ``Trainer.predict`` / ``evaluate`` against the JAX Trainer,
plus the port's import boundary and ``chip_smoke.py``'s refusal to run
without a card.

The JAX side serves with ``interpret=True`` (the Pallas kernels under their
interpreter); the port on the CPU serves through the same model math.
Tolerance: rtol 1e-4 / atol 1e-5, the repository's f32 gate.
"""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import connectome_gnn_tpu as jp
import connectome_gnn_tpu_torch as tp
from connectome_gnn_tpu_torch.models import load_jax_params

RTOL, ATOL = 1e-4, 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = {"gcn": (jp.GCNConnectome, tp.GCNConnectome),
           "sage": (jp.GraphSAGEConnectome, tp.GraphSAGEConnectome)}


@pytest.fixture(scope="module")
def graphs():
    jg = jp.generate_dataset(num_subjects=10, num_regions=16, seed=9)
    tg = tp.generate_dataset(num_subjects=10, num_regions=16, seed=9)
    # unlabeled graphs are the core serving case: they still get logits
    jg[3].label = tg[3].label = None
    return jg, tg


@pytest.fixture(scope="module")
def trainers(graphs):
    """Per kind: a JAX Trainer with non-trivial BN state, and the port's
    Trainer over the same weights."""
    jg, _ = graphs
    out = {}
    for kind, (jcls, tcls) in CLASSES.items():
        jmodel = jcls(in_channels=5, hidden_dim=16, num_layers=2)
        params, state = jmodel.init(jax.random.PRNGKey(0))
        batch = jp.data.collate_dense(jg)
        _, state = jmodel.apply(params, state, batch, train=True, rng=jax.random.PRNGKey(1))
        tmodel = tcls(in_channels=5, hidden_dim=16, num_layers=2)
        load_jax_params(
            tmodel,
            jax.tree_util.tree_map(np.asarray, params),
            jax.tree_util.tree_map(np.asarray, state),
        )
        out[kind] = (
            jp.Trainer(jmodel, params=params, state=state, prefetch_depth=0),
            tp.Trainer(tmodel, device="cpu"),
        )
    return out


def loaders(graphs, layout):
    jg, tg = graphs
    kw = dict(batch_size=4, shuffle=False, layout=layout)
    return jp.ConnectomeDataLoader(jg, **kw), tp.ConnectomeDataLoader(tg, **kw)


@pytest.mark.parametrize("layout", ["dense", "coo"])
@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_predict_matches_jax(graphs, trainers, kind, layout):
    jt, tt = trainers[kind]
    jl, tl = loaders(graphs, layout)
    want = jt.predict(jl, interpret=True) if layout == "dense" else jt.predict(jl, prefer_fused=False)
    got = tt.predict(tl, prefer_fused=layout == "dense")
    assert got.shape == want.shape == (10, 2)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tt.predict(tl, prefer_fused=False), got, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("layout", ["dense", "coo"])
@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_evaluate_matches_jax(graphs, trainers, kind, layout):
    jt, tt = trainers[kind]
    jl, tl = loaders(graphs, layout)
    want, got = jt.evaluate(jl), tt.evaluate(tl)
    assert got["total"] == want["total"] == 9  # one unlabeled graph
    assert got["correct"] == want["correct"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["accuracy"], want["accuracy"])


def test_predict_warns_once_on_coo_batches(graphs, trainers):
    _, tt = trainers["gcn"]
    _, tl = loaders(graphs, "coo")
    tt._warned_unfusable = False
    with pytest.warns(UserWarning, match="COO-layout") as record:
        tt.predict(tl)
        tt.predict(tl)
    assert len([w for w in record if "COO-layout" in str(w.message)]) == 1


def test_trainer_moves_the_model_and_batches_to_its_device(graphs):
    _, tg = graphs
    model = tp.GCNConnectome(in_channels=5, hidden_dim=16)
    trainer = tp.Trainer(model, device=torch.device("cpu"))
    assert trainer.device == torch.device("cpu")
    assert next(trainer.model.parameters()).device.type == "cpu"
    out = trainer.predict(tp.ConnectomeDataLoader(tg, batch_size=3, shuffle=False,
                                                  layout="dense", device="cpu"))
    assert out.shape == (10, 2) and np.isfinite(out).all()


def test_trainer_defaults_to_the_card_and_refuses_to_fall_back(monkeypatch):
    """``Trainer(model)`` runs on ``cuda``; without a card it raises and
    names ``device="cpu"``, which still works."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = tp.GCNConnectome(in_channels=5, hidden_dim=16)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tp.Trainer(model)
    assert tp.Trainer(model, device="cpu").device == torch.device("cpu")


def small_spatial_graph():
    return tp.generate_spatial_graph(256, degree=4, band=16, seed=1)


#: each entry point of sampled training, called without ``device``
SAMPLED_ENTRY_POINTS = {
    "SampledNodeLoader": lambda: tp.SampledNodeLoader(small_spatial_graph(), batch_size=8,
                                                      fanout=(2, 2)),
    "DeviceGraphCSR.from_graph": lambda: tp.data.DeviceGraphCSR.from_graph(small_spatial_graph()),
    "DeviceSeedLoader": lambda: tp.DeviceSeedLoader(np.arange(16), batch_size=8),
    "Trainer": lambda: tp.Trainer(tp.NodeGCN(5, 8)),
}


@pytest.mark.parametrize("entry", list(SAMPLED_ENTRY_POINTS))
def test_sampled_entry_points_default_to_the_card(monkeypatch, entry):
    """Without a card and without ``device="cpu"`` each raises and names
    ``device="cpu"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        SAMPLED_ENTRY_POINTS[entry]()


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, connectome_gnn_tpu_torch, connectome_gnn_tpu_torch.ops.fused, "
        "connectome_gnn_tpu_torch.ops._build, connectome_gnn_tpu_torch.ops.banded, "
        "connectome_gnn_tpu_torch.ops.banded_quant, connectome_gnn_tpu_torch.ops.banded_direct, "
        "connectome_gnn_tpu_torch.ops.band_variants, connectome_gnn_tpu_torch.ops.fm_variants, "
        "connectome_gnn_tpu_torch.ops.gather_dma, connectome_gnn_tpu_torch.data.reorder, "
        "connectome_gnn_tpu_torch.data.prefetch, connectome_gnn_tpu_torch.train.fault, "
        "connectome_gnn_tpu_torch.train.checkpoint, connectome_gnn_tpu_torch.train.trainer, "
        "connectome_gnn_tpu_torch.models.node_gcn, connectome_gnn_tpu_torch.models.node_sage, "
        "connectome_gnn_tpu_torch.native, connectome_gnn_tpu_torch.data.layout, "
        "connectome_gnn_tpu_torch.entry, connectome_gnn_tpu_torch.data.sampling, "
        "connectome_gnn_tpu_torch.data.sampled, connectome_gnn_tpu_torch.data.device_sampling, "
        "connectome_gnn_tpu_torch.models.node_coo, connectome_gnn_tpu_torch.parallel, "
        "connectome_gnn_tpu_torch.parallel.mesh, connectome_gnn_tpu_torch.parallel.distributed, "
        "connectome_gnn_tpu_torch.parallel.shard_forward, "
        "connectome_gnn_tpu_torch.parallel.data_parallel, "
        "connectome_gnn_tpu_torch.parallel.edge_partition, "
        "connectome_gnn_tpu_torch.parallel.banded_partition, "
        "connectome_gnn_tpu_torch.parallel.hybrid_partition, "
        "connectome_gnn_tpu_torch.parallel.launch, connectome_gnn_tpu_torch.parallel.sampled_dp, "
        "connectome_gnn_tpu_torch.parallel.sharded_sampling, "
        "connectome_gnn_tpu_torch.parallel.comm_accounting, connectome_gnn_tpu_torch.data.io, "
        "connectome_gnn_tpu_torch.utils, connectome_gnn_tpu_torch.utils.profiling\n"
        "import importlib.util\n"
        "spec = importlib.util.spec_from_file_location('demo', 'examples/giant_graph_demo_torch.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')) "
        "or m == 'connectome_gnn_tpu' or m.startswith('connectome_gnn_tpu.')]\n"
        "assert not bad, bad"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path, alone):
    """Without CUDA (here) and in a directory holding nothing else of the
    repository, chip_smoke.py exits non-zero and prints no result."""
    if torch.cuda.is_available() and not alone:
        pytest.skip("a CUDA card is present")
    cwd = REPO
    if alone:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
