"""Utilities: a ``torch.profiler`` trace and a device-synchronizing step
timer (:mod:`~connectome_gnn_tpu_torch.utils.profiling`), and the port's
tree rules for nested containers (:mod:`~connectome_gnn_tpu_torch.utils.tree`)."""

from connectome_gnn_tpu_torch.utils.profiling import StepTimer, trace

__all__ = ["StepTimer", "trace"]
