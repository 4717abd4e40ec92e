"""Find a cell's parts by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Each part is a file of its own, found by name:

  configs/<config>.json      the configuration (the ``file`` of its entry)
  traffic/<traffic>.json     the traffic mix, read by ``generator.py``
  cells/<workload>.json      the cell's batch, how its gaps are measured, and
                             the limit of each number the check compares
  metrics/<metric>.py        the reader of one per-layer metric

so a new cell, configuration, traffic mix or metric is a new entry in
``BENCHMARK.json`` plus new files, and no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict  # the configuration file as loaded
    traffic: dict  # the traffic file as loaded
    batch: int
    chips: int
    end_to_end: list  # entries of BENCHMARK.json's end_to_end this cell reports
    per_layer: list  # entries of BENCHMARK.json's per_layer this cell reports
    limits: dict  # number name -> its limit
    gap: str  # "absolute", or "over_plain": over the plain reference's own gap


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark_spec(root=ROOT):
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing: the benchmark's cells are listed there")
    return load_json(path)


def _reported(metric, cell_name):
    wl = metric.get("workloads")
    return wl is None or cell_name in wl


def load_cell(name, root=ROOT, spec=None):
    spec = benchmark_spec(root) if spec is None else spec
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    conf_entry = configs[w["config"]]
    config = load_json(Path(root) / conf_entry["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    own = load_json(BENCH_DIR / "cells" / f"{name}.json")
    e2e = [m for m in spec["end_to_end"] if _reported(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if _reported(m, name) and m["moves"] in e2e_names]
    return Cell(name=name, config=config, traffic=traffic,
                batch=int(own["batch"]), chips=int(w["chips"]), end_to_end=e2e,
                per_layer=per_layer, limits=own["limits"], gap=own["gap"])


def metric_reader(name):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    mod_name = "benchmark_metric_" + "".join(ch if ch.isalnum() else "_" for ch in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
