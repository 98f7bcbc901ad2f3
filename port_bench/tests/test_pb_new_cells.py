"""A later cell is data: a workload file that names an existing kind,
model and route, and its entry in ``BENCHMARK.json``.  Cells that no file
of the benchmark names yet (GCN served over the int8 and float32 bands,
GCN trained over the float32 band) run whole on the CPU at a small size
and come out correct, with no code of the harness changed."""

import json
import time

import pytest

from port_bench import harness

SMALL = dict(num_nodes=8192, batch_size=128)
SEED = 3_000_000_029
SERVE = dict(kind="closed_loop_serve", forwards_per_unit=1, kept_requests=2, kept_from_first=4,
             trace_units=2, warm_up_seconds=0.1)
NEW = {
    "giant_gcn.serve_int8": dict(SERVE, route="int8_fm",
                                 limits={"logit_rel_err": 6e-3, "logit_max_gap": 2e-2}),
    "giant_gcn.serve_f32": dict(SERVE, route="float32",
                                limits={"logit_rel_err": 2e-5, "logit_max_gap": 3e-5}),
    "giant_gcn.train_f32": dict(kind="full_graph_train", route="float32", forwards_per_unit=3,
                                trace_units=2, warm_up_seconds=0.1,
                                limits={"loss_gap": 1e-5, "grad_gap": 1e-4, "change_gap": 1e-3}),
}


@pytest.mark.parametrize("cell", sorted(NEW))
def test_a_cell_made_of_data_alone_runs_correct(cell, monkeypatch):
    bench = json.loads(json.dumps(harness.load_benchmark()))
    config, traffic = cell.split(".")
    bench["workloads"].append({"name": cell, "config": config, "traffic": traffic, "chips": 1,
                               "why": "a test cell"})
    rate = "serve_p95_ms" if "serve" in traffic else "train_nodes_per_s"
    for m in bench["end_to_end"]:
        if m["name"] == rate:
            m["workloads"].append(cell)
    known = harness.load_workload
    monkeypatch.setattr(harness, "load_workload",
                        lambda name: dict(NEW[name]) if name in NEW else known(name))
    result = harness.run_cell(cell, SEED, 0.3, False, "cpu", t_start=time.perf_counter(),
                              log=lambda m: None, overrides=SMALL, bench=bench)
    assert result["correct"], result["compared"]
    assert set(result["compared"]) == set(NEW[cell]["limits"])
    assert rate in result["metrics"]
