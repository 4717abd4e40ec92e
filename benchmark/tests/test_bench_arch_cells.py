"""The cells ``full_arch_point1.sweep_loop`` (the box arch's closed loops)
and ``full_bottle_point1.batched_solve`` (the bottle's batched solve), and
the per-layer metrics ``balance_ms.*`` that read the span ``ocp.balance``.

Each cell loads with its own batch and limits; the runs of
``test_bench_reference.py`` hold on each: on the CPU at batch 4 correct on
the sound program and not correct on each fault planted there, on the card
the control failing where the program passes; the balance readers give None
untraced and on the CPU.
"""

import pytest

from benchmark import registry, trace
from benchmark.tests.test_bench_reference import (
    test_control_fails_on_the_card as control_case,
    test_run_is_correct_only_when_the_timed_path_is as run_case,
)
from benchmark.tests.test_bench_spans import synthetic
from upright_tpu_torch import tracing

CELLS = {"full_arch_point1.sweep_loop": ("loop", 8192),
         "full_bottle_point1.batched_solve": ("solve", 16384)}
NUMBERS = {"loop": {"trajectory", "multipliers", "cost", "input", "ee", "object_r", "cold"},
           "solve": {"gain", "trajectory", "multipliers", "cost", "cold"}}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_the_cells_load_with_their_batches(name):
    cell = registry.load_cell(name)
    kind, batch = CELLS[name]
    assert cell.traffic["kind"] == kind and cell.batch == batch and cell.chips == 1
    assert set(cell.limits) == NUMBERS[kind]
    # each limit lies between the program's largest reading and the
    # control's smallest, from the card readings kept beside it
    readings = registry.load_json(registry.BENCH_DIR / "cells" / f"{name}.json")["readings"]
    for k, lim in cell.limits.items():
        assert readings[k]["program_max"] < lim < readings[k]["control_min"], k
    reported = {m["name"] for m in cell.per_layer}
    assert f"balance_ms.{kind}" in reported


CASES = [(cell, kind) for cell in sorted(CELLS)
         for kind in (None, "state_unchanged", "half_batch", "altered")]


@pytest.mark.parametrize("name,fault", CASES, ids=[f"{c}-{f or 'sound'}" for c, f in CASES])
def test_run_is_correct_only_when_the_timed_path_is(name, fault, monkeypatch):
    run_case(name, fault, monkeypatch)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CELLS))
def test_control_fails_on_the_card(name):
    control_case(name)


@pytest.mark.parametrize("name", ["balance_ms.solve", "balance_ms.loop"])
def test_balance_readers_give_none_untraced_and_on_the_cpu(name, monkeypatch):
    monkeypatch.setattr(tracing, "_records", [])
    kind = name.rsplit(".", 1)[1]
    read = registry.metric_reader(name)
    assert read({"kind": kind, "trace": None}) is None
    events = synthetic() + [{"ph": "X", "cat": "cpu_op", "name": "ocp.balance",
                             "ts": 125.0, "dur": 20.0}]
    cpu = trace.parse([e for e in events if e["cat"] in ("user_annotation", "cpu_op")], 2)
    assert read({"kind": kind, "trace": cpu}) is None
    # on a card with no event pair of the span (a program without it): None
    assert read({"kind": kind, "trace": trace.parse(events, 2)}) is None
    # another kind's cell reads nothing
    other = "loop" if kind == "solve" else "solve"
    assert read({"kind": other, "trace": trace.parse(events, 2)}) is None
