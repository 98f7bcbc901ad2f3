"""Kernel and graph launches the host issued (CUDA runtime calls in the
profiled window) per training step.  A captured epoch replays one graph a
step; an eager step launches every kernel itself.  Moves
``sampled_seeds_per_s``."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0 or not run.units:
        return None
    return run.trace.launches / run.units
