"""What the program's own spans say in a traced run, for the readers of the
per-layer metrics of one phase.

The program (``upright_tpu_torch/tracing.py``) opens a span at each phase
boundary of its solver and closed loop.  The profiler exports a span as a
``cpu_op`` event, so it lies in ``Trace.host_ops`` on the trace's clock;
while the profiler records, a span on the card also records a pair of CUDA
events, which the program's ``tracing.card_ms()`` reads.  Each function
gives one span's time a traced unit, summed over its occurrences in the
traced units, and None where there is nothing to read: no trace, no card
(no device interval in the trace), or no such span (a program without it).
"""

from __future__ import annotations

from benchmark import stats


def _occurrences(tr, name):
    return [(s, e) for n, s, e in tr.host_ops if n == name]


def _on_card(tr):
    return tr is not None and tr.units > 0 and bool(tr.device)


def host_ms(tr, name):
    """The host's time in span ``name``: its own duration (ms a unit)."""
    if not _on_card(tr):
        return None
    occ = _occurrences(tr, name)
    if not occ:
        return None
    return 1e-3 * sum(e - s for s, e in occ) / tr.units


def idle_ms(tr, name):
    """The card's idle time under span ``name`` (ms a unit): the gaps
    between the device's intervals inside the traced window whose midpoint
    falls inside one of the span's occurrences on the host."""
    if not _on_card(tr):
        return None
    occ = stats.union(_occurrences(tr, name))
    if not occ:
        return None
    idle = sum(ge - gs for gs, ge in stats.gaps(tr.device, *tr.window)
               if any(s <= 0.5 * (gs + ge) < e for s, e in occ))
    return 1e-3 * idle / tr.units


def card_ms(tr, name):
    """The card's time in span ``name``: the time between its two CUDA
    events (ms a unit)."""
    if not _on_card(tr):
        return None
    try:
        from upright_tpu_torch import tracing
    except ImportError:  # a program without spans
        return None
    if tracing.dropped:
        return None
    ms = tracing.card_ms().get(name)
    if not ms:
        return None
    return sum(ms) / tr.units
