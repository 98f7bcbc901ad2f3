"""The benchmark's general harness: one cell, one run.

Everything about a cell is found by name: its entry in ``BENCHMARK.json``,
its configuration's file, its traffic in ``port_bench/workloads/<cell>.json``,
the traffic kind, model and route files those name, and each per-layer
metric's reader in ``port_bench/metrics/<metric>.py`` (``parts.py``).
"""

from __future__ import annotations

import gc
import json
import math
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import torch

from port_bench import parts, trace

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "port_bench"
#: top-level modules that must not be loaded in the process that reports
FORBIDDEN = ("jax", "jaxlib", "flax", "connectome_gnn_tpu")
GIB = float(1 << 30)


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def find_cell(bench: dict, cell: str) -> tuple[dict, dict]:
    """The cell's workload entry and its configuration's entry."""
    for w in bench["workloads"]:
        if w["name"] == cell:
            for c in bench["configs"]:
                if c["name"] == w["config"]:
                    return w, c
            raise KeyError(f"cell {cell} names no configuration {w['config']!r}")
    raise KeyError(f"no workload {cell!r} in BENCHMARK.json")


def load_config(entry: dict) -> dict:
    return json.loads((ROOT / entry["file"]).read_text())


def load_workload(cell: str) -> dict:
    return json.loads((BENCH / "workloads" / f"{cell}.json").read_text())


def metrics_of(bench: dict, cell: str, section: str) -> list[dict]:
    """The cell's metrics of ``end_to_end`` or ``per_layer``: those that list
    it, or list no cells and move a metric the cell reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if section == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell]) and m["moves"] in names]


def forbidden_modules() -> list[str]:
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})


@dataclass
class TracedRun:
    """What a per-layer reader reads."""

    cell: str
    config: dict
    workload: dict
    trace: Optional[trace.TraceSummary]
    units: int
    spans: dict
    #: nodes, edges and head rows of one unit's forward where the sample
    #: sets them (None: the configuration's whole graph)
    shapes: Optional[dict] = None


def run_cell(cell: str, seed: int, seconds: float, traced: bool, device, *, t_start: float,
             log=print, overrides: Optional[dict] = None, workload_overrides: Optional[dict] = None,
             bench: Optional[dict] = None) -> dict:
    """One run of ``cell``: set-up, the window (or the profiled window with
    ``traced``), the memory peak, the program's state freed, then the
    comparison with the reference and the metrics.  Returns the result line's object, with
    ``compared`` last.  ``overrides`` and ``workload_overrides`` replace keys
    of the configuration and of the traffic (the CPU tests' small sizes)."""
    bench = bench or load_benchmark()
    entry, config_entry = find_cell(bench, cell)
    config = {**load_config(config_entry), **(overrides or {})}
    workload = {**load_workload(cell), **(workload_overrides or {})}
    device = torch.device(device)
    log(f"set-up: process start to the harness {time.perf_counter() - t_start:.3f} s")
    t0 = time.perf_counter()
    torch.zeros(1, device=device)
    log(f"set-up: device context {time.perf_counter() - t0:.3f} s")
    runner = parts.kind(workload["kind"])(config, workload, seed, device, log)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    runner.setup()
    with runner.span("warm_up_s"):
        runner.warm_up(workload["warm_up_seconds"])
    setup_s = time.perf_counter() - t_start
    log(f"set-up: {setup_s:.3f} s in all")
    if traced:
        units = {}
        window = trace.profile(lambda: units.setdefault("n", runner.traced()), device)
        measured = {"attempted": units["n"], "failed": 0}
        calls = sorted(window.runtime_calls.items(), key=lambda kv: -kv[1])[:12]
        log(f"traced: {units['n']} units, host runtime calls {dict(calls)}")
    else:
        measured, window = runner.window(seconds), None
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    runner.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings = runner.readings()
    limits = workload["limits"]
    compared = {k: {"value": float(v), "limit": float(limits[k])} for k, v in readings.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in compared.values())

    metrics = {}
    if traced:
        run = TracedRun(cell, config, workload, window, measured["attempted"], runner.spans,
                        runner.unit_shapes())
        for m in metrics_of(bench, cell, "per_layer"):
            value = parts.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = {**measured, "peak_mem_gib": peak / GIB, "setup_s": setup_s}
        for m in metrics_of(bench, cell, "end_to_end"):
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}

    found = forbidden_modules()
    if found:
        raise RuntimeError(f"loaded in the reporting process: {', '.join(found)}")

    result = {
        "correct": correct,
        "attempted": int(measured["attempted"]),
        "failed": int(measured["failed"]),
        "metrics": metrics,
        "device": device_info(device, peak, window),
    }
    if window is not None:
        result["breakdown"] = window.breakdown()
    result["compared"] = compared
    return result


def device_info(device, peak: int, window: Optional[trace.TraceSummary]) -> dict:
    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": 1, "memory_peak_bytes": int(peak)}
    if window is not None:
        info["busy_s"] = window.busy_s
        info["window_s"] = window.window_s
    return info
