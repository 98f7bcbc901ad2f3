"""Each band product's bytes bound over the device time of the kernels the
cell's workload file names, in the train cells (`_readers.band_roofline_pct`)."""

from port_bench.metrics._readers import band_roofline_pct as read  # noqa: F401
