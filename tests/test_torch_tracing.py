"""The spans of ``upright_tpu_torch/tracing.py`` in the solver and the closed
loop, on thing_demo at N 3, B 2, float64 on the CPU: one warm solve and two
device-loop ticks under torch.profiler, read from the exported Chrome trace.

Each span is a ``cpu_op`` event (the category of ``_RecordFunctionFast``,
which ``benchmark/trace.py`` keeps as a host operator), the four ``al.*``
phases of each iteration lie inside ``al.solve`` and cover it, ``al.solve``
lies inside ``loop.replan`` in a tick, and no CUDA event is recorded on the
CPU or without a profiler.  The event pairs a span records on the card are
held on stand-in events.
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import upright_tpu_torch.config as cfg
from benchmark import trace
from upright_tpu_torch import tracing
from upright_tpu_torch.ocp.problem import build_problem
from upright_tpu_torch.ocp.reference import stack_targets
from upright_tpu_torch.runtime.device_loop import build_device_loop
from upright_tpu_torch.sim.simulation import UprightSimulation
from upright_tpu_torch.solver.al import ALConfig, solve
from upright_tpu_torch.solver.ocp import zeros_warm_start

CPU64 = dict(device="cpu", dtype=torch.float64)
PHASES = ("al.linearize", "al.backward", "al.line_search", "al.update")
SPANS = ("al.solve",) + PHASES + ("loop.replan", "loop.plant")
TICKS = 2


@pytest.fixture(scope="module")
def thing():
    conf = cfg.load_config(cfg.resolve_package_path(
        {"package": "configs", "path": "demos/thing_demo.yaml"}))
    prob = build_problem(conf, N=3, **CPU64)
    # one object substep in place of 40: the same path, a fortieth of the
    # plant's operators in the trace
    sim = UprightSimulation(dict(conf["simulation"], object_substeps=1), **CPU64)
    target = stack_targets([prob.target, prob.target])
    init_carry, run = build_device_loop(prob, sim)
    sim0 = sim.initial_state(batch=2)
    x0 = torch.cat([sim0.q, sim0.v, torch.zeros_like(sim0.q)], dim=-1)
    # a one-iteration solve from rest is the warm start (init_carry's cold
    # solve takes twelve)
    warm = solve(prob.ocp, ALConfig(iterations=1), prob.stage_params(0.0, target), x0,
                 zeros_warm_start(prob.ocp, x0, **CPU64), **CPU64).state
    carry = init_carry(target=target, sim_state=sim0, solver_state=warm)

    def warm_solve():
        solve(prob.ocp, ALConfig(iterations=1), prob.stage_params(0.0, target), x0,
              carry.solver, **CPU64)

    return warm_solve, lambda: run(carry, TICKS, target=target)


@pytest.fixture(scope="module")
def events(thing, tmp_path_factory):
    warm_solve, ticks = thing
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.WINDOW_SPAN):
            warm_solve()
            ticks()
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def _occurrences(events, name):
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                  if e["name"] == name)


def _inside(inner, outer):
    return [i for i in inner if outer[0] <= i[0] and i[1] <= outer[1]]


def test_every_span_is_a_cpu_op(events):
    for name in SPANS:
        cats = {e.get("cat") for e in events if e["name"] == name}
        assert cats == {"cpu_op"}, (name, cats)
    assert len(_occurrences(events, "al.solve")) == 1 + TICKS
    assert len(_occurrences(events, "loop.replan")) == TICKS
    assert len(_occurrences(events, "loop.plant")) == TICKS


def test_phases_tile_each_solve_inside_the_replan(events):
    solves = _occurrences(events, "al.solve")
    phases = {name: _occurrences(events, name) for name in PHASES}
    for s in solves:
        inside = [_inside(phases[name], s) for name in PHASES]
        assert [len(i) for i in inside] == [1, 1, 1, 1]  # one SQP iteration
        spans = [i[0] for i in inside]
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))  # in order
        covered = sum(e - b for b, e in spans)
        assert covered >= 0.95 * (s[1] - s[0]), (covered, s[1] - s[0])
    for replan, plant in zip(_occurrences(events, "loop.replan"),
                             _occurrences(events, "loop.plant")):
        assert len(_inside(solves, replan)) == 1
        assert replan[1] <= plant[0]


def test_the_benchmarks_parse_keeps_the_spans(events):
    tr = trace.parse(events, units=1)
    names = {n for n, _, _ in tr.host_ops}
    assert set(SPANS) <= names


def test_no_event_pairs_on_the_cpu_or_without_a_profiler(thing, events):
    # the profiled run on the CPU recorded none
    assert tracing.card_ms() == {} and tracing.dropped == 0
    warm_solve, _ = thing
    warm_solve()  # no profiler
    assert tracing.card_ms() == {} and tracing.parents() == {}


class _Event:
    """A stand-in for ``torch.cuda.Event``: its time is the order of record."""
    clock = 0

    def __init__(self, enable_timing=False):
        assert enable_timing

    def record(self):
        _Event.clock += 1
        self.t = _Event.clock

    def elapsed_time(self, end):
        return float(end.t - self.t)


def test_a_span_on_the_card_records_an_event_pair_under_its_parent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(tracing, "MAX_RECORDS", 3)
    tracing.reset()
    with tracing.span("loop.replan", "cuda"):  # no profiler: no events
        pass
    assert tracing.card_ms() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with tracing.span("loop.replan", torch.device("cuda")):
                with tracing.span("al.solve", "cuda"):
                    pass
            with tracing.span("loop.plant", "cpu"):  # not on the card: no events
                pass
    # the first replan's events bracket its solve's two; the second replan
    # is past the bound of three pairs
    assert tracing.card_ms() == {"al.solve": [1.0, 1.0], "loop.replan": [3.0]}
    assert tracing.parents() == {"al.solve": "loop.replan", "loop.replan": None}
    assert tracing.dropped == 1
    tracing.reset()
    assert tracing.card_ms() == {} and tracing.dropped == 0
