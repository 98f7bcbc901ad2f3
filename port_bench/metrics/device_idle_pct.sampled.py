"""Share of the profiled window in which the device ran nothing, in the
cells that report `sampled_seeds_per_s` (`_readers.device_idle_pct`)."""

from port_bench.metrics._readers import device_idle_pct as read  # noqa: F401
