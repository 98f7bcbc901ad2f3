"""Utilities: a ``torch.profiler`` trace and a device-synchronizing step
timer (:mod:`~connectome_gnn_tpu_torch.utils.profiling`)."""

from connectome_gnn_tpu_torch.utils.profiling import StepTimer, trace

__all__ = ["StepTimer", "trace"]
