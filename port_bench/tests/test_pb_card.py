"""On the card: one short run of each cell at its own size comes out
correct, and the control comes out not correct there.  Skips without a
card; run on the H100 with
``python -m pytest -p no:cacheprovider port_bench/tests/test_pb_card.py``."""

import time

import pytest
import torch

from port_bench import harness, parts

pytestmark = pytest.mark.requires_cuda
BENCH = harness.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(cell, cuda):
    result = harness.run_cell(cell, 4_000_000_123, 1.0, False, cuda, t_start=time.perf_counter(),
                              log=lambda m: None, bench=BENCH)
    assert result["correct"], result["compared"]
    assert result["device"]["kind"] == torch.cuda.get_device_name(0)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_at_the_cells_size(cell, cuda):
    _, config_entry = harness.find_cell(BENCH, cell)
    workload = harness.load_workload(cell)
    runner = parts.kind(workload["kind"])(harness.load_config(config_entry), workload,
                                               4_000_000_321, torch.device(cuda), lambda m: None)
    readings = runner.control_readings()
    assert any(readings[k] > limit for k, limit in workload["limits"].items()), readings
