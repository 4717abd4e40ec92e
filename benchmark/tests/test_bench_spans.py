"""The readers of the program's spans (``benchmark/spans.py`` and the
per-layer metrics that use it), on synthetic traces: idle ms under a host
span, host ms, card ms through a stand-in record list, and None where there
is nothing to read."""

import pytest
import torch

from benchmark import registry, spans, stats, trace
from upright_tpu_torch import tracing


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def synthetic():
    """Two traced units in the window 100-1100, the solver's spans nested
    in the loop's, and device work with gaps at both window edges, inside
    the spans and outside every span."""
    return [
        _ev("user_annotation", trace.WINDOW_SPAN, 100.0, 1000.0),
        _ev("user_annotation", trace.PROGRAM_SPAN, 110.0, 400.0),
        _ev("cpu_op", "loop.replan", 110.0, 250.0),
        _ev("cpu_op", "al.solve", 120.0, 230.0),
        _ev("cpu_op", "al.linearize", 120.0, 130.0),
        _ev("cpu_op", "aten::mm", 130.0, 50.0),
        _ev("cpu_op", "al.line_search", 250.0, 100.0),
        _ev("cpu_op", "loop.plant", 360.0, 150.0),
        _ev("user_annotation", trace.PROGRAM_SPAN, 600.0, 400.0),
        _ev("cpu_op", "loop.replan", 600.0, 200.0),
        _ev("cpu_op", "al.solve", 610.0, 190.0),
        _ev("cpu_op", "al.linearize", 610.0, 90.0),
        _ev("cpu_op", "al.line_search", 700.0, 100.0),
        _ev("cpu_op", "loop.plant", 800.0, 200.0),
        # device: idle 100-140 (window edge; mid 120 in al.linearize), busy
        # 140-200, idle 200-300 (mid 250: al.line_search's start), busy
        # 300-520, idle 520-580 (mid 550: no span), busy 580-1000 but for
        # 650-690 (mid 670: al.linearize) and 900-960 (mid 930:
        # loop.plant), idle 1000-1100 (window edge; mid 1050: no span)
        _ev("kernel", "gemm", 140.0, 60.0),
        _ev("kernel", "gemm", 300.0, 220.0),
        _ev("kernel", "gemm", 580.0, 70.0),
        _ev("gpu_memcpy", "Memcpy HtoD", 690.0, 210.0),
        _ev("kernel", "plant_kernel", 960.0, 40.0),
    ]


@pytest.fixture
def tr():
    return trace.parse(synthetic(), units=2)


def test_idle_under_a_span_is_named_by_the_gaps_midpoint(tr):
    # 40 + 40 us under al.linearize over two units
    assert spans.idle_ms(tr, "al.linearize") == pytest.approx(1e-3 * 80 / 2)
    assert spans.idle_ms(tr, "al.line_search") == pytest.approx(1e-3 * 100 / 2)
    # the nested spans' gaps count in their parents too
    assert spans.idle_ms(tr, "al.solve") == pytest.approx(1e-3 * 180 / 2)
    assert spans.idle_ms(tr, "loop.replan") == pytest.approx(1e-3 * 180 / 2)
    assert spans.idle_ms(tr, "loop.plant") == pytest.approx(1e-3 * 60 / 2)
    # the gaps outside every span (550, 1050) are nobody's
    total = sum(ge - gs for gs, ge in stats.gaps(tr.device, *tr.window))
    assert total == pytest.approx(180 + 60 + 60 + 100)
    # a span with no gap under it reads 0, a span that never opened None
    assert spans.idle_ms(trace.parse(synthetic()[:14] + [_ev("kernel", "k", 0.0, 2000.0)], 2),
                         "al.linearize") == 0.0
    assert spans.idle_ms(tr, "al.backward") is None


def test_host_ms_is_the_spans_own_duration(tr):
    assert spans.host_ms(tr, "loop.plant") == pytest.approx(1e-3 * (150 + 200) / 2)
    assert spans.host_ms(tr, "al.solve") == pytest.approx(1e-3 * (230 + 190) / 2)
    assert spans.host_ms(tr, "al.update") is None


class _Event:
    def __init__(self, t):
        self.t = t

    def elapsed_time(self, end):
        return end.t - self.t


def test_card_ms_sums_the_event_pairs_over_the_units(tr, monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(tracing, "_records", [
        ("al.solve", "loop.replan", _Event(0.0), _Event(3.0)),
        ("al.linearize", "al.solve", _Event(0.0), _Event(1.5)),
        ("al.linearize", "al.solve", _Event(5.0), _Event(6.0)),
    ])
    monkeypatch.setattr(tracing, "dropped", 0)
    assert spans.card_ms(tr, "al.linearize") == pytest.approx(2.5 / 2)
    assert spans.card_ms(tr, "al.solve") == pytest.approx(3.0 / 2)
    assert spans.card_ms(tr, "loop.plant") is None
    ctx = {"kind": "solve", "trace": tr}
    assert registry.metric_reader("linearize_ms.solve")(ctx) == pytest.approx(1.25)
    assert registry.metric_reader("replan_ms.loop")(ctx) is None  # another cell's
    # a record list cut at its bound undercounts: nothing is read
    monkeypatch.setattr(tracing, "dropped", 1)
    assert spans.card_ms(tr, "al.linearize") is None


CARD = ["linearize_ms.solve", "line_search_ms.solve", "replan_ms.loop", "plant_ms.loop"]
HOST = ["linearize_idle_ms.solve", "line_search_idle_ms.solve", "replan_idle_ms.loop",
        "plant_idle_ms.loop", "plant_host_ms.loop"]


@pytest.mark.parametrize("name", CARD + HOST)
def test_readers_give_none_untraced_and_on_the_cpu(name, tr, monkeypatch):
    monkeypatch.setattr(tracing, "_records", [])
    kind = name.rsplit(".", 1)[1]
    read = registry.metric_reader(name)
    assert read({"kind": kind, "trace": None}) is None
    # a CPU trace: the spans on the host, no device interval
    cpu = trace.parse([e for e in synthetic() if e["cat"] in ("user_annotation", "cpu_op")], 2)
    assert read({"kind": kind, "trace": cpu}) is None
    # on a card the trace's own readers read; the card's need event pairs
    value = read({"kind": kind, "trace": tr})
    assert value is None if name in CARD else value > 0
