"""BENCHMARK.json and the files the harness finds by name: every cell's
configuration and traffic, every per-layer metric's reader, and the
contract's rules on names, keys and cells that a file can break."""

import json
import re

import pytest

from port_bench import harness, parts

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_entries_have_just_the_contracts_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("port_bench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and w["name"] == f"{w['config']}.{w['traffic']}"
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_names_are_unique_and_well_formed():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files_and_reports_what_it_must(cell):
    entry, config_entry = harness.find_cell(BENCH, cell)
    config = harness.load_config(config_entry)
    workload = harness.load_workload(cell)
    assert isinstance(parts.kind(workload["kind"]), type)
    assert callable(parts.model(config["model"]).reference_logits)
    if "route" in workload:
        assert callable(parts.route(workload["route"]).prepare)
    assert config["name"] == config_entry["name"]
    e2e = {m["name"] for m in harness.metrics_of(BENCH, cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = harness.metrics_of(BENCH, cell, "per_layer")
    assert per_layer and all(m["moves"] in e2e for m in per_layer)
    assert set(workload["limits"]) and all(v > 0 for v in workload["limits"].values())


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_each_per_layer_metric_has_a_reader(metric):
    assert callable(parts.reader(metric))
    for cell in [m for m in BENCH["per_layer"] if m["name"] == metric][0].get("workloads", []):
        assert cell in CELLS


def test_a_missing_part_is_named():
    with pytest.raises(KeyError, match="kinds/no_such_kind.py"):
        parts.kind("no_such_kind")


def test_at_most_four_end_to_end_metrics_besides_setup():
    assert len([m for m in BENCH["end_to_end"] if m["name"] != "setup_s"]) <= 4


def test_the_file_is_small():
    assert len(json.dumps(BENCH)) < 64 * 1024
