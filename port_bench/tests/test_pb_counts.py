"""The operations and bytes the per-layer metrics count, against counts
made by hand from the configurations' sizes (1,048,576 nodes, degree 38,
band ±512 in blocks of 256, F = H = 64, L = 2)."""

import pytest

from port_bench import harness
from port_bench.metrics import _counts

BENCH = harness.load_benchmark()


def config(name):
    return harness.load_config(harness.find_cell(BENCH, f"{name}")[1])


GCN, SAGE = config("giant_gcn.train_int8"), config("giant_sage.serve_int8")
N, E = 1_048_576, 1_048_576 * 38


def test_band_width_and_edges():
    assert _counts.band_width_blocks(GCN) == 2
    assert _counts.num_edges(GCN) == E == 39_845_888


@pytest.mark.parametrize("band_bytes, want_bytes, want_ms", [
    # int8 band 4096·5·256² B, a float32 scale a tile, x read and out written
    (1, 1_342_177_280 + 81_920 + 536_870_912, 0.561),
    # float32 band, no scales
    (4, 5_368_709_120 + 536_870_912, 1.763),
])
def test_band_product_bound(band_bytes, want_bytes, want_ms):
    assert _counts.band_product_bytes(GCN, band_bytes, 64) == want_bytes
    assert round(_counts.band_product_seconds(GCN, band_bytes, 64) * 1e3, 3) == want_ms


def test_gcn_train_step_operations():
    per_layer = 2 * N * 64 * 64 + 2 * E * 64
    forward = 2 * per_layer + 2 * N * 64 * 2
    assert forward == 27_648_851_968
    assert _counts.unit_flops(GCN, {"forwards_per_unit": 3}) == 3 * forward


def test_sage_forward_operations():
    per_layer = 2 * E * 64 + 2 * N * 128 * 64
    assert _counts.unit_flops(SAGE, {"forwards_per_unit": 1}) == 2 * per_layer + 2 * N * 64 * 2


def test_sampled_step_operations_are_the_samples():
    shapes = {"nodes": 90_000, "edges": 112_640, "head_rows": 1024}
    forward = 2 * (2 * 90_000 * 64 * 64 + 2 * 112_640 * 64) + 2 * 1024 * 64 * 2
    workload = {"forwards_per_unit": 3, "counted_over": "sample"}
    assert _counts.unit_flops(GCN, workload, shapes) == 3 * forward
    assert _counts.unit_flops(GCN, workload) is None


@pytest.mark.parametrize("config, want", [
    # GCN projects first: each layer's product carries F_out
    (dict(in_channels=16, hidden_dim=64, num_layers=2, aggregates="after_projection"), [64, 64]),
    # SAGE aggregates first: layer 0 carries the input's width
    (dict(in_channels=16, hidden_dim=64, num_layers=2, aggregates="before_projection"), [16, 64]),
])
def test_each_layers_product_carries_its_own_width(config, want):
    assert _counts.aggregated_widths(config) == want


def test_a_pass_sums_its_layers_products():
    narrow = {**SAGE, "in_channels": 16}
    want = (_counts.band_product_seconds(narrow, 4, 16)
            + _counts.band_product_seconds(narrow, 4, 64))
    assert _counts.band_pass_seconds(narrow, 4) == pytest.approx(want)
    assert _counts.band_pass_seconds(GCN, 1) == pytest.approx(
        2 * _counts.band_product_seconds(GCN, 1, 64))
