"""Resolve a cell of ``BENCHMARK.json`` to the files that define it.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by name, so that a later change adds a cell by
adding files and entries and edits none:

- ``BENCHMARK.json`` (the checkout's root): the cells and metrics;
- a configuration: the ``file`` its entry names (``configs/<name>.json``);
- a traffic mix: ``traffic/<traffic>.json``;
- a cell's limits on the numbers that decide ``correct``:
  ``limits/<cell>.json``;
- a per-layer metric: ``metrics/<metric>.py``, a ``read(records)``
  function that returns a number, or None where it finds nothing to read.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
from typing import Callable

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # BENCHMARK.json entries this cell reports with --trace 0
    per_layer: list  # ... and with --trace 1


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    bench = benchmark(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(by_name)}")
    w = by_name[name]
    configs = {c["name"]: c for c in bench["configs"]}
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=load_json(root / configs[w["config"]]["file"]),
        traffic=load_json(root / HERE.name / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(root / HERE.name / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def reader(metric: str, root: pathlib.Path = ROOT) -> Callable[[dict], float | None]:
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = root / HERE.name / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(f"fftconv_bench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
