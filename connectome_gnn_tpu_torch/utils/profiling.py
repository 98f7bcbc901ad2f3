"""Profiling and timing utilities.

The port of ``connectome_gnn_tpu/utils/profiling.py``: :func:`trace`
wraps ``torch.profiler`` (a Chrome-format trace that TensorBoard's
profiler plugin and Perfetto open), and :class:`StepTimer` is a wall-clock
step timer that waits for the device work behind a step's result.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

from connectome_gnn_tpu_torch.utils.tree import leaves_with_path


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a trace of the enclosed block: CPU activity, and CUDA
    activity where a card is present.  On exit the trace is written to
    ``log_dir/trace_<pid>_<ns>.pt.trace.json``.

    Example::

        with profiling.trace("runs/trace"):
            trainer.train_epoch(loader)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.pt.trace.json")
        )


def _cuda_devices(result) -> set:
    """The CUDA devices of the tensor leaves of ``result``, a tree by the
    rules of :mod:`connectome_gnn_tpu_torch.utils.tree` (dataclasses,
    NamedTuples, dicts, lists and tuples), as JAX's ``block_until_ready``
    walks a pytree."""
    return {leaf.device for _, leaf in leaves_with_path(result)
            if isinstance(leaf, torch.Tensor) and leaf.is_cuda}


class StepTimer:
    """Wall-clock timer with device synchronization and simple stats.

    ``tic()``/``toc(result)`` around a step; ``toc`` waits until the device
    work behind ``result`` has finished (``torch.cuda.synchronize`` on each
    CUDA device among its tensor leaves, dataclasses' fields included), so the measurement covers device
    execution, not just dispatch.  ``toc()`` without a result waits for
    nothing.
    """

    def __init__(self) -> None:
        self.times: list[float] = []
        self._t0: Optional[float] = None

    def tic(self) -> None:
        self._t0 = time.perf_counter()

    def toc(self, result=None) -> float:
        if result is not None:
            for device in _cuda_devices(result):
                torch.cuda.synchronize(device)
        if self._t0 is None:
            raise RuntimeError("toc() without tic()")
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        self._t0 = None
        return dt

    @property
    def total(self) -> float:
        return sum(self.times)

    @property
    def mean(self) -> float:
        return self.total / len(self.times) if self.times else 0.0

    def summary(self, skip_first: int = 1) -> dict:
        """Mean/min/total excluding the first ``skip_first`` (warm-up) steps."""
        steady = self.times[skip_first:] or self.times
        return {
            "steps": len(self.times),
            "total_s": self.total,
            "mean_s": sum(steady) / len(steady) if steady else 0.0,
            "min_s": min(steady) if steady else 0.0,
        }
