"""Whole runs of each cell on the CPU at a small size with the cell's own
limits, past the harness's look for a card: a sound run comes out
correct, and one with the timed path broken underneath comes out not
correct, once for each fault the cell can have: a step that leaves the
state unchanged, half of the batch left out with the mean over the rest,
an answer altered where it is produced.  (One card a cell: no exchange
between chips to leave out.)"""

import time

import pytest
import torch

from port_bench import harness, parts

#: the configurations' widths and degree at a few thousand nodes
SMALL = dict(num_nodes=8192, batch_size=128)
SMALL_TRAFFIC = dict(pool_size=1024, kept_from_first=4, kept_requests=2, trace_units=2,
                     warm_up_seconds=0.1)
SEED = 3_000_000_017
#: the int8 training cell's gaps grow as the graph shrinks (fewer nodes
#: average the bfloat16 rounding of the band product's input): at this size
#: its sound runs read loss 1.7e-5 and gradients 1.7e-3 against 2.7e-6 and
#: 4.7e-4 at the cell's own size, so the test holds it to limits of its size
SMALL_LIMITS = {"giant_gcn.train_int8": {"loss_gap": 1e-4, "grad_gap": 1e-2, "change_gap": 3e-2}}


def run(cell, traced=False):
    overrides = dict(SMALL_TRAFFIC)
    if cell in SMALL_LIMITS:
        overrides["limits"] = SMALL_LIMITS[cell]
    return harness.run_cell(cell, SEED, 0.3, traced, "cpu", t_start=time.perf_counter(),
                            log=lambda m: None, overrides=SMALL, workload_overrides=overrides)


def no_step(self, *args, **kwargs):
    return None


FULL_GRAPH_TRAIN = parts.kind("full_graph_train")
WHOLE_BATCH_LOSS = FULL_GRAPH_TRAIN.loss


def half_the_batch(self, logits, labels, labelled):
    keep = labelled & (torch.arange(labelled.numel()) < labelled.numel() // 2)
    return WHOLE_BATCH_LOSS(self, logits, labels, keep)


def alter_one_answer(method):
    def altered(*args, **kwargs):
        out = method(*args, **kwargs).clone()
        out[out.shape[0] // 3, 0] += 1.0
        return out
    return altered


@pytest.mark.parametrize("cell", [w["name"] for w in harness.load_benchmark()["workloads"]])
def test_a_sound_run_is_correct(cell):
    result = run(cell)
    assert result["correct"], result["compared"]
    assert list(result)[-1] == "compared"


@pytest.mark.parametrize("cell", ["giant_gcn.train_int8", "giant_gcn.train_sampled"])
def test_a_step_that_leaves_the_state_unchanged_is_caught(cell, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", no_step)
    assert not run(cell)["correct"]


def test_half_of_the_full_graph_batch_left_out_is_caught(monkeypatch):
    monkeypatch.setattr(FULL_GRAPH_TRAIN, "loss", half_the_batch)
    assert not run("giant_gcn.train_int8")["correct"]


def test_half_of_the_sampled_batch_left_out_is_caught(monkeypatch):
    from connectome_gnn_tpu_torch.data.device_sampling import SeedBatch

    whole = SeedBatch.label_mask.fget
    monkeypatch.setattr(SeedBatch, "label_mask", property(
        lambda self: whole(self) & (torch.arange(self.num_seeds) < self.num_seeds // 2)))
    assert not run("giant_gcn.train_sampled")["correct"]


@pytest.mark.parametrize("cell, method", [("giant_sage.serve_int8", "apply_quantized"),
                                          ("giant_sage.serve_f32", "forward")])
def test_an_altered_answer_is_caught(cell, method, monkeypatch):
    from connectome_gnn_tpu_torch.models.node_sage import BandedNodeSAGE

    monkeypatch.setattr(BandedNodeSAGE, method, alter_one_answer(getattr(BandedNodeSAGE, method)))
    assert not run(cell)["correct"]


def test_a_traced_run_reads_no_device_metric_on_the_cpu():
    result = run("giant_gcn.train_int8", traced=True)
    assert set(result["metrics"]) == {"graph_build_s"}
    assert result["correct"] and result["device"]["busy_s"] == 0.0
