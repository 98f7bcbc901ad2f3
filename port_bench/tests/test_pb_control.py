"""The control at a small size: the plain reference put in the program's
place in the next lower precision the configuration states (int4 for the
int8 band, TF32 for float32) comes out not correct by the cell's own
limits.  On the card the same readings are taken at each cell's own size
by ``port_bench/readings.py --control-seeds``."""

import pytest
import torch

from port_bench import harness, parts

SMALL = dict(num_nodes=8192, batch_size=128)
SMALL_TRAFFIC = dict(pool_size=1024, kept_from_first=4, kept_requests=2)
BENCH = harness.load_benchmark()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("seed", [11, 2**31 + 5])
def test_the_control_fails_a_limit(cell, seed):
    _, config_entry = harness.find_cell(BENCH, cell)
    config = {**harness.load_config(config_entry), **SMALL}
    workload = {**harness.load_workload(cell), **SMALL_TRAFFIC}
    runner = parts.kind(workload["kind"])(config, workload, seed, torch.device("cpu"),
                                               lambda m: None)
    readings = runner.control_readings()
    assert any(readings[k] > limit for k, limit in workload["limits"].items()), readings
