"""The per-layer readers over a trace summary made by hand: what each
reads, and that a reader with nothing to read returns nothing."""

import pytest

from port_bench import harness, parts, trace
from port_bench.metrics import _counts

BENCH = harness.load_benchmark()


def traced_run(cell, summary, units=10, shapes=None):
    _, config_entry = harness.find_cell(BENCH, cell)
    return harness.TracedRun(cell, harness.load_config(config_entry), harness.load_workload(cell),
                             summary, units, {"graph_build_s": 2.5}, shapes)


def summary(**kw):
    base = dict(window_s=0.2, busy_s=0.18, device_span_s=0.19,
                kernels={"void (anonymous namespace)::band_mma_kernel<1>": 0.05, "gemm": 0.1},
                op_device_s={"_BandWindows": 0.08}, runtime_calls={"cudaGraphLaunch": 10,
                                                               "cudaMemcpyAsync": 12})
    base.update(kw)
    return trace.TraceSummary(**base)


def read(metric, run):
    return parts.reader(metric)(run)


def test_idle_and_launches():
    run = traced_run("giant_gcn.train_sampled", summary())
    assert read("device_idle_pct.sampled", run) == pytest.approx(10.0)
    assert read("host_launches_per_step", run) == pytest.approx(1.0)
    assert read("graph_build_s", run) == 2.5


@pytest.mark.parametrize("cell, metric", [("giant_gcn.train_int8", "train_mfu_pct"),
                                          ("giant_sage.serve_f32", "serve_mfu_pct")])
def test_mfu_is_the_counted_work_over_the_devices_span_over_the_peak(cell, metric):
    run = traced_run(cell, summary())
    want = 100 * _counts.unit_flops(run.config, run.workload) * 10 / 0.19 / 989e12
    assert read(metric, run) == pytest.approx(want)


def test_sampled_mfu_counts_the_sample():
    shapes = {"nodes": 60_000.0, "edges": 112_640.0, "head_rows": 1024}
    run = traced_run("giant_gcn.train_sampled", summary(), shapes=shapes)
    per_layer = 2 * 60_000 * 64 * 64 + 2 * 112_640 * 64
    want = 3 * (2 * per_layer + 2 * 1024 * 64 * 2) * 10 / 0.19 / 989e12
    assert read("sampled_mfu_pct", run) == pytest.approx(100 * want)
    assert read("sampled_mfu_pct", traced_run("giant_gcn.train_sampled", summary())) is None


@pytest.mark.parametrize("cell, seconds, band_bytes, passes", [
    ("giant_gcn.train_int8", 0.05, 1, 2),
    ("giant_sage.serve_int8", 0.05, 1, 1),
    ("giant_sage.serve_f32", 0.08, 4, 1),
])
def test_band_roofline_reads_the_kernels_its_cell_names(cell, seconds, band_bytes, passes):
    run = traced_run(cell, summary())
    metric = "band_spmm_roofline_pct." + ("train" if "train" in cell else "serve")
    bound = 2 * _counts.band_product_seconds(run.config, band_bytes, 64)
    assert read(metric, run) == pytest.approx(100 * bound * passes * 10 / seconds)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]
                                    if m["name"] != "graph_build_s"])
def test_no_device_time_reads_nothing(metric):
    cell = BENCH["per_layer"][[m["name"] for m in BENCH["per_layer"]].index(metric)]["workloads"][0]
    assert read(metric, traced_run(cell, summary(busy_s=0.0, kernels={}, op_device_s={}))) is None
    assert read(metric, traced_run(cell, None)) is None


def test_a_roofline_whose_kernels_did_not_run_reads_nothing():
    run = traced_run("giant_sage.serve_int8", summary(kernels={"gemm": 0.1}))
    assert read("band_spmm_roofline_pct.serve", run) is None
