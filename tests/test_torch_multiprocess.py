"""The parallel modes in real processes on gloo, held to one process, and
that process to the JAX package.

``connectome_gnn_tpu_torch.parallel.launch`` runs the programs ``dp``,
``banded``, ``hybrid`` and ``trainer_fit`` over 4 shards as 1 process × 4
shards, 2 × 2 and 4 × 1, each worker building only its shards, each with
its own time limit.  Every rank's losses, parameter checksums, counts and
first-step gradient checksums must agree with the one-process run within
1e-4, the bound of the JAX rig's two-step programs
(``benchmarks/multiprocess.py:30-37``).  A gradient counted once per
process (a ``psum`` of the loss inside the forward, or a second all-reduce)
would scale the gradient checksum by the process count, which
``test_gradients_are_counted_once`` would see.  The one-process run is
held to JAX's data-parallel step and mesh-mode Trainer on the same weights.
"""

import jax
import numpy as np
import optax
import pytest
import torch

import connectome_gnn_tpu.data as jd
import connectome_gnn_tpu.parallel as jp
from connectome_gnn_tpu.models import GCNConnectome as JGCN
from connectome_gnn_tpu.models.compat import params_from_reference_state_dict
from connectome_gnn_tpu.train import Trainer as JTrainer

from connectome_gnn_tpu_torch import GCNConnectome
from connectome_gnn_tpu_torch.parallel import launch

SHARDS = 4
PROCS = (2, 4)
#: a worker's limit: each run takes 5-10 s on the CPU
TIMEOUT_S = 180.0


@pytest.fixture(scope="module")
def runs():
    return {procs: launch.launch(procs, SHARDS, device="cpu", timeout_s=TIMEOUT_S) for procs in (1, *PROCS)}


@pytest.mark.parametrize("program", launch.PROGRAMS)
@pytest.mark.parametrize("procs", PROCS)
def test_processes_agree_with_one(runs, procs, program):
    assert len(runs[procs]) == procs
    assert [r["rank"] for r in runs[procs]] == list(range(procs))
    drift = launch.compare(runs[1], runs[procs])[program]
    assert drift["ok"], drift


@pytest.mark.parametrize("procs", PROCS)
def test_gradients_are_counted_once(runs, procs):
    for program in ("dp", "banded", "hybrid"):
        want = runs[1][0]["results"][program]["grads_sum"]
        for rank in runs[procs]:
            got = rank["results"][program]["grads_sum"]
            assert abs(got - want) <= 1e-4 * want, (program, procs, got, want)


@pytest.mark.parametrize("procs", PROCS)
def test_replicas_stay_identical(runs, procs):
    """Every rank applies the same reduced gradients: the parameters agree
    across ranks bitwise."""
    for program in launch.PROGRAMS:
        sums = {r["results"][program]["params_sum"] for r in runs[procs]}
        assert len(sums) == 1, (program, sums)


def _jax_params(model):
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    return params_from_reference_state_dict(sd, num_layers=2)


def _checksum(tree) -> float:
    return float(sum(np.abs(np.asarray(x, np.float64)).sum()
                     for x in jax.tree_util.tree_leaves(tree)))


def test_one_process_dp_is_jax(runs):
    """The ``dp`` program's two steps in JAX (4 virtual devices, the port's
    initial weights): losses and the parameter checksum within 1e-4."""
    got = runs[1][0]["results"]["dp"]
    model = GCNConnectome(in_channels=5, hidden_dim=16, num_layers=2, dropout=0.0,
                          generator=torch.Generator().manual_seed(0))
    params, state = _jax_params(model)
    mesh = jp.create_mesh(shape=(SHARDS,), devices=jax.devices()[:SHARDS])
    jm = JGCN(in_channels=5, hidden_dim=16, num_layers=2, dropout=0.0)
    opt = optax.adam(1e-3)
    step = jp.make_dp_train_step(jm, opt, mesh)
    graphs = jd.generate_dataset(num_subjects=2 * SHARDS, num_regions=20, seed=3)
    batch = next(iter(jd.ConnectomeDataLoader(graphs, batch_size=2 * SHARDS, shuffle=False,
                                              num_shards=SHARDS)))
    opt_state, losses = opt.init(params), []
    for _ in range(2):
        params, state, opt_state, loss, n = step(params, state, opt_state,
                                                 jax.random.PRNGKey(1), batch)
        losses.append(float(loss))
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-4)
    np.testing.assert_allclose(got["params_sum"], _checksum(params), rtol=1e-4)
    assert got["n"] == float(n)


def test_one_process_trainer_fit_is_jax(runs):
    """The ``trainer_fit`` program in JAX's mesh-mode Trainer: three epochs'
    train and validation losses and the parameter checksum within 1e-4."""
    got = runs[1][0]["results"]["trainer_fit"]
    model = GCNConnectome(in_channels=5, hidden_dim=16, num_layers=2, dropout=0.0,
                          generator=torch.Generator().manual_seed(0))
    params, state = _jax_params(model)
    graphs = jd.generate_dataset(num_subjects=6 * SHARDS, num_regions=20, seed=13)
    train = jd.ConnectomeDataLoader(graphs[: 4 * SHARDS], batch_size=2 * SHARDS, shuffle=True,
                                    seed=0, num_shards=SHARDS)
    val = jd.ConnectomeDataLoader(graphs[4 * SHARDS :], batch_size=2 * SHARDS, shuffle=False,
                                  num_shards=SHARDS)
    trainer = JTrainer(JGCN(in_channels=5, hidden_dim=16, num_layers=2, dropout=0.0),
                       params=params, state=state, seed=0,
                       mesh=jp.create_mesh(shape=(SHARDS,), devices=jax.devices()[:SHARDS]))
    hist = trainer.fit(train, val, num_epochs=3, patience=10, verbose=False)
    np.testing.assert_allclose(got["losses"], hist["train_loss"] + hist["val_loss"], rtol=1e-4)
    np.testing.assert_allclose(got["params_sum"], _checksum(trainer.params), rtol=1e-4)
    assert got["n"] == float(trainer.evaluate(val)["total"])


def test_a_worker_past_its_limit_is_killed():
    with pytest.raises(RuntimeError, match="outlived"):
        launch.launch(2, SHARDS, ("dp",), device="cpu", timeout_s=0.5)


@pytest.mark.parametrize("argv", [None, ["--procs", "1", "--shards", "2"]])
def test_the_launcher_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch, argv):
    """Without ``device`` the launcher takes the card (NCCL); with no card
    it raises before it starts a worker, never falling back to gloo."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='pass device="cpu"'):
        if argv is None:
            launch.launch(1, SHARDS, ("dp",))
        else:
            launch.main(argv)
