"""A ``torch.profiler`` window reduced to what the per-layer metrics read:
the device's busy intervals, kernel time by name and by the operator that
launched it, the host's runtime launches, and the idle gaps with what the
host was doing in each.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

#: host runtime calls that put a kernel or a captured graph on the device
LAUNCH_CALLS = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
    "cudaLaunchCooperativeKernel", "cudaGraphLaunch", "cuGraphLaunch",
})


@dataclass
class TraceSummary:
    #: the profiled window by the host's clock
    window_s: float
    #: the union of the device's kernel and copy intervals
    busy_s: float
    #: the first device interval's start to the last one's end
    device_span_s: float = 0.0
    #: device seconds by kernel (or copy) name
    kernels: dict = field(default_factory=dict)
    #: device seconds of the kernels each host operator launched
    op_device_s: dict = field(default_factory=dict)
    #: host runtime calls by name
    runtime_calls: dict = field(default_factory=dict)
    #: idle seconds by what the host was doing
    idle_by_host: dict = field(default_factory=dict)

    @property
    def launches(self) -> int:
        return sum(n for name, n in self.runtime_calls.items() if name in LAUNCH_CALLS)

    def device_time(self, patterns) -> float:
        """Device seconds of the kernels whose names hold any of
        ``patterns``."""
        return sum(s for name, s in self.kernels.items() if any(p in name for p in patterns))

    def breakdown(self) -> dict:
        """The ten device operations that took most time and the ten
        largest idle sums by host operator, names cut to 120 characters."""
        def top(d):
            short = defaultdict(float)
            for k, v in d.items():
                short[k[:120]] += v
            return [[k, v] for k, v in sorted(short.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(self.kernels), "idle_gaps": top(self.idle_by_host)}


def _is_device(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA


def profile(run, device) -> TraceSummary:
    """Profile ``run()`` (which ends its work on the device) and reduce it."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        window = time.perf_counter() - t0
    return summarize(prof, window)


def summarize(prof, window_s: float) -> TraceSummary:
    events = list(prof.events())
    annotations = {e.name for e in events if getattr(e, "is_user_annotation", False)}
    device = [e for e in events if _is_device(e) and e.name not in annotations
              and not getattr(e, "is_user_annotation", False)]
    host = [e for e in events if not _is_device(e)]

    kernels = defaultdict(float)
    spans = []
    for e in device:
        kernels[e.name] += (e.time_range.end - e.time_range.start) * 1e-6
        spans.append((e.time_range.start, e.time_range.end))
    spans.sort()
    merged = []
    for s, t in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged) * 1e-6
    span = (merged[-1][1] - merged[0][0]) * 1e-6 if merged else 0.0

    runtime = defaultdict(int)
    for e in host:
        if e.name.startswith(("cuda", "cu")) and not e.name.startswith("cudnn"):
            runtime[e.name] += 1

    op_device = {}
    for row in prof.key_averages():
        if row.device_type != torch.autograd.DeviceType.CUDA and row.device_time_total > 0:
            op_device[row.key] = row.device_time_total * 1e-6

    # what the host was doing in each gap: the innermost host operator
    # (not a runtime call) that spans the gap's middle
    ops = sorted(((e.time_range.start, e.time_range.end, e.name) for e in host
                  if e.name not in runtime), key=lambda x: x[0])
    starts = [o[0] for o in ops]
    idle = defaultdict(float)
    if merged and ops:
        lo, hi = ops[0][0], max(o[1] for o in ops)
        edges = [(lo, merged[0][0])] + [(merged[i][1], merged[i + 1][0])
                                        for i in range(len(merged) - 1)] + [(merged[-1][1], hi)]
        for s, t in edges:
            if t <= s:
                continue
            mid = (s + t) / 2
            name = "(no host operator)"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 4096, -1), -1):
                if ops[j][1] >= mid:
                    name = ops[j][2]
                    break
            idle[name] += (t - s) * 1e-6
    return TraceSummary(window_s, busy, span, dict(kernels), op_device, dict(runtime),
                        dict(idle))
