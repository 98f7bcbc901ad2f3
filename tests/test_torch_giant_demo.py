"""``examples/giant_graph_demo_torch.py`` on the CPU at a small size,
against the JAX package's host functions on the same seeds.

One run at 2,048 nodes, 4 band steps and 2 shards: its host-side numbers
(edges, bandwidths, the band's shape, the hybrid's remainder, the sampled
minibatch) must equal those of ``generate_spatial_graph``,
``reverse_cuthill_mckee``, ``bandwidth``, ``to_banded``, ``to_hybrid`` and
``NeighborSampler.sample`` of the JAX package, drawn from
``default_rng(0)`` in the JAX demo's order; the sharded band and hybrid
logits must be within 1e-4 of the single model's; every loss finite.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import connectome_gnn_tpu.data as jd
import connectome_gnn_tpu.ops as jops
from connectome_gnn_tpu.data import reorder as jr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--cpu", "--nodes", "2048", "--steps", "4", "--shards", "2"]
N, DEGREE, BAND = 2048, 12, 256
HOST_KEYS = ("edges", "scrambled_bandwidth", "rcm_bandwidth", "row_blocks", "diagonals",
             "shortcuts", "sampled_nodes", "sampled_edges")


def load_demo():
    spec = importlib.util.spec_from_file_location(
        "giant_graph_demo_torch", os.path.join(REPO, "examples", "giant_graph_demo_torch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def demo():
    return load_demo()


@pytest.fixture(scope="module")
def run(demo):
    return demo.main(ARGS)


@pytest.fixture(scope="module")
def jax_numbers(demo):
    rng = np.random.default_rng(0)
    g = jd.generate_spatial_graph(N, degree=DEGREE, band=BAND, seed=0)
    scrambled = jr.apply_ordering(g, rng.permutation(N))
    recovered = jr.apply_ordering(scrambled, jr.reverse_cuthill_mckee(scrambled.edge_index, N))
    a = jops.to_banded(recovered.edge_index[0], recovered.edge_index[1], recovered.edge_weight, N,
                       block=demo.BLOCK)
    sw = jd.generate_spatial_graph(N, degree=DEGREE, band=BAND, seed=3, shortcut_frac=0.1)
    h = jops.to_hybrid(sw.edge_index[0], sw.edge_index[1], sw.edge_weight, N, block=demo.BLOCK,
                       bandwidth=-(-BAND // demo.BLOCK))
    sub, _ = jd.NeighborSampler(sw).sample(rng.integers(0, N, 512), fanout=[10, 10], seed=0)
    return dict(edges=g.num_edges, scrambled_bandwidth=jr.bandwidth(scrambled.edge_index),
                rcm_bandwidth=jr.bandwidth(recovered.edge_index), row_blocks=a.num_blocks,
                diagonals=2 * a.bandwidth + 1,
                shortcuts=int((np.asarray(h.remainder_weights) > 0).sum()),
                sampled_nodes=sub.num_nodes, sampled_edges=sub.num_edges)


@pytest.mark.parametrize("key", HOST_KEYS)
def test_host_side_numbers_are_the_jax_packages(run, jax_numbers, key):
    assert run[key] == jax_numbers[key]


@pytest.mark.parametrize("key", ["sharded_max_diff", "hybrid_sharded_max_diff"])
def test_sharded_logits_match_the_single_model(run, key):
    assert run["shards"] == 2
    assert run[key] is not None and run[key] <= 1e-4


@pytest.mark.parametrize("key", ["losses", "sampled_losses", "device_sampled_losses",
                                 "graph_sharded_losses"])
def test_every_loss_is_finite(run, key):
    assert len(run[key]) > 0 and np.isfinite(run[key]).all()


def test_every_section_ran_on_the_cpu(run):
    assert run["device"] == "cpu" and run["devices"] == ["cpu"]
    assert sorted(run["seconds"]) == list(range(1, 12)) and run["peak_bytes"] == {}
    assert len(run["losses"]) == 4 and [e[0] for e in run["evals"]] == [1, 2, 3, 4]
    assert run["overflow"] == 0
    assert run["capped_max_in_degree"] <= 8 < run["max_in_degree"]


def test_one_shard_prints_the_skip_lines(demo, capsys):
    out = demo.main(["--cpu", "--nodes", "1024", "--steps", "1", "--shards", "1"])
    printed = capsys.readouterr().out
    assert "skipping the sharded cross-check" in printed
    assert "skipping the graph-sharded sampling section" in printed
    assert out["sharded_max_diff"] is None and out["hybrid_sharded_max_diff"] is None
    assert "overflow" not in out and sorted(out["seconds"]) == list(range(1, 10))


def test_the_defaults_are_the_jax_demos(demo):
    args = demo.parse_args([])
    assert (args.nodes, args.degree, args.band, args.steps, args.shards, args.cpu) == (
        20_000, 12, 256, 200, 4, False)
    assert (demo.BLOCK, demo.HIDDEN, demo.FANOUT, demo.BATCH) == (128, 64, (10, 10), 1024)


def test_without_a_card_it_raises_rather_than_run_on_the_cpu(demo, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        demo.main(["--nodes", "1024", "--steps", "1"])


def test_a_band_and_a_model_on_different_devices_are_refused(demo):
    model = torch.nn.Linear(2, 2)
    demo.require_same_device(torch.zeros(1), model)
    with pytest.raises(RuntimeError, match="the band is on meta"):
        demo.require_same_device(torch.zeros(1, device="meta"), model)
