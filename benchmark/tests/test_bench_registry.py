"""The benchmark finds every part of a cell by name, and a new cell needs
only data."""

import dataclasses
import json

import pytest

from benchmark import registry

SPEC = registry.benchmark_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_by_name(name):
    cell = registry.load_cell(name)
    assert cell.traffic["kind"] in ("solve", "loop")
    assert cell.config["name"] == name.split(".")[0]
    assert cell.batch >= 1 and cell.chips == 1
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_batches_are_the_deployments():
    assert registry.load_cell("thing_demo.batched_solve").batch == 16384
    assert registry.load_cell("full_bottle_point1.sweep_loop").batch == 8192


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(registry.metric_reader(metric))


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_configuration_files_name_their_source(entry):
    conf = registry.load_json(registry.ROOT / entry["file"])
    assert conf["name"] == entry["name"] and conf["source"] == entry["source"]
    assert conf["reduced"] == entry["reduced"]
    assert conf["dtype"] == "float32"
    assert {"controller", "simulation"} <= set(conf["config"])


@pytest.mark.parametrize("name", CELLS)
def test_every_number_of_a_cell_has_a_limit(name):
    cell = registry.load_cell(name)
    want = {"solve": {"gain", "trajectory", "multipliers", "cost", "cold"},
            "loop": {"trajectory", "multipliers", "cost", "input", "ee", "object_r", "cold"}}[cell.traffic["kind"]]
    assert set(cell.limits) == want
    assert all(v > 0 for v in cell.limits.values())
    assert cell.gap in ("absolute", "over_plain")


def test_a_cell_takes_its_batch_and_limits_from_its_own_file_alone():
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append(dict(spec["workloads"][0], name="thing_demo.no_such_cell"))
    with pytest.raises(FileNotFoundError):
        registry.load_cell("thing_demo.no_such_cell", spec=spec)
    own = registry.load_json(registry.BENCH_DIR / "cells" / f"{CELLS[0]}.json")
    assert registry.load_cell(CELLS[0]).batch == own["batch"]
