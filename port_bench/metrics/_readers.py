"""The readers that several metrics share, one per quantity: a metric's
file names its quantity and imports its reader from here.  Each returns
None where the trace holds nothing for it to read."""

from port_bench.metrics import _counts


def device_idle_pct(run):
    """Share of the profiled window in which no kernel or copy ran on the
    device: the union of their intervals against the window's host-clock
    length."""
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - run.trace.busy_s / run.trace.window_s)


def mfu_pct(run):
    """The model's operations in the profiled window, counted from the
    configuration's shapes (``_counts.unit_flops``), over the device's span
    of the window (the first kernel's start to the last one's end, by the
    trace), over 989 TFLOP/s (dense bf16)."""
    if run.trace is None or run.trace.busy_s <= 0 or not run.units:
        return None
    flops = _counts.unit_flops(run.config, run.workload, run.shapes)
    if flops is None:
        return None
    return 100.0 * flops * run.units / run.trace.device_span_s / _counts.PEAK_FLOPS


def band_roofline_pct(run):
    """A layer's band product ``A @ x`` against its bytes bound: the passes
    the profiled window ran over every layer's product (the workload's
    ``band_product.passes`` a step or request: 2 in training, forward and
    backward) times the least time each takes (``_counts.band_pass_seconds``:
    the band at the width the cell stores it, ``x`` read once and the
    output written once at the width that layer carries, at 3.35 TB/s),
    over the device time of the kernels that compute it.  The workload
    names them under ``band_product``: by kernel name (``kernels``), or by
    the host operator that launches every kernel of the product (``ops``,
    its device time with its children's)."""
    spec = run.workload.get("band_product")
    if spec is None or run.trace is None or run.trace.busy_s <= 0 or not run.units:
        return None
    seconds = run.trace.device_time(spec.get("kernels", ()))
    seconds += sum(run.trace.op_device_s.get(op, 0.0) for op in spec.get("ops", ()))
    if seconds <= 0:
        return None
    bound = _counts.band_pass_seconds(run.config, spec["band_bytes"])
    return 100.0 * bound * spec["passes"] * run.units / seconds
