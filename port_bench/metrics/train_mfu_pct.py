"""The whole full-graph training step's share of the chip's peak, over the
configuration's whole graph (`_readers.mfu_pct`)."""

from port_bench.metrics._readers import mfu_pct as read  # noqa: F401
