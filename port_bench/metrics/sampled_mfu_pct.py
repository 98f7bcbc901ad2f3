"""The whole sampled training step's share of the chip's peak, over the
sampled nodes and edges of a step: the mean of the compared steps' samples
as the reference draws them, not the blocks' padded slots
(`_readers.mfu_pct`; the workload is `counted_over` the sample)."""

from port_bench.metrics._readers import mfu_pct as read  # noqa: F401
