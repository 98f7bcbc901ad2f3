"""The files the harness finds by name, each ``port_bench/<folder>/<name>.py``:

- ``kinds/<kind>.py``: a traffic kind (its class ``Kind``), named by a
  workload file's ``kind``;
- ``models/<model>.py``: a configuration's model on both sides, the
  program's class and the plain reference's forward, named by a
  configuration's ``model``;
- ``routes/<route>.py``: how the program's model prepares the band and
  runs over it, named by a workload file's ``route``;
- ``metrics/<metric>.py``: a per-layer metric's reader (its ``read``),
  named by the metric.

A later cell, model, route or metric is a new file; none is listed here.
Each file is loaded once a process, so every caller sees one module.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

BENCH = Path(__file__).resolve().parent
_loaded: dict = {}


def load(folder: str, name: str):
    path = BENCH / folder / f"{name}.py"
    if path not in _loaded:
        if not path.is_file():
            where = path.relative_to(BENCH.parent)
            raise KeyError(f"no {folder[:-1]} {name!r}: {where} is missing")
        spec = importlib.util.spec_from_file_location(f"port_bench.{folder}.{name}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _loaded[path] = module
    return _loaded[path]


def kind(name: str):
    return load("kinds", name).Kind


def model(name: str):
    return load("models", name)


def route(name: str):
    return load("routes", name)


def reader(name: str):
    return load("metrics", name).read
