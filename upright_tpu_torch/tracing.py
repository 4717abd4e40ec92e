"""Spans at the phase boundaries of the solver and the closed loop.

``span(name, device)`` marks one phase of the program.  It always opens a
profiler record function, which a ``torch.profiler`` trace exports as a
``cpu_op`` event on the profiler's own clock, beside the device intervals of
the same trace; with no profiler recording that is all it costs (under a
microsecond).  While a profiler records, a span on a CUDA device whose
current stream is not capturing a graph also records a pair of timing CUDA
events on that stream, so that ``card_ms()`` can give the card's time from
the span's start to its end.  The profiler is the only switch.

The spans (each phase ends where the next begins, so they tile their
parent):

  al.solve        ``solver/al.py`` ``solve``, the whole call
    al.linearize    pin x0, the dynamics Jacobians, the defects, the AL stage
                    and final derivatives
    al.backward     the Riccati backward pass and the copies it takes
    al.line_search  the candidates' rollouts and merits, the incoming merit,
                    argmin, accept and the selects
    al.update       the dual update and the diagnostics
  loop.replan     ``runtime/device_loop.py`` ``tick``: observe, shift and
                  heal the warm start, the stage parameters, ``solve``
  loop.plant      the policy, the command integration, ``sim.step`` and the
                  EE pose after it

and, inside whichever phase evaluates or differentiates the stage rows:

  ocp.balance     ``ocp/problem.py``: the contact forces' expansion and the
                  objects' wrench balances in ``eq``, the friction cones in
                  the inequality rows (under ``jacfwd`` an occurrence holds
                  the rows' primal and tangent kernels)

The port's other instruments are two counters: ``solver/riccati.py``
``launch_count`` (K1 launches; the benchmark's one-launch-per-iteration
check reads it) and ``sim/contact.py`` ``launch_count`` (P1 launches;
``scripts/ral23_sweep.py`` differences it per window).
"""

from __future__ import annotations

import threading

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

MAX_RECORDS = 65536  # event pairs kept; the rest are counted in ``dropped``

_records = []  # (name, parent name, start event, end event)
_lock = threading.Lock()
_local = threading.local()  # .stack: the names of this thread's open spans
dropped = 0


class span:
    """``with span(name, device):`` around one phase of the program."""

    __slots__ = ("_name", "_device", "_rf", "_stack", "_parent", "_start")

    def __init__(self, name, device):
        self._name = name
        self._device = device

    def __enter__(self):
        self._rf = _RecordFunctionFast(self._name)
        self._rf.__enter__()
        self._stack = self._start = None
        if _autograd_profiler._is_profiler_enabled:
            self._stack = _open_spans()
            self._parent = self._stack[-1] if self._stack else None
            self._stack.append(self._name)
            if torch.device(self._device).type == "cuda" \
                    and not torch.cuda.is_current_stream_capturing():
                self._start = torch.cuda.Event(enable_timing=True)
                self._start.record()
        return self

    def __exit__(self, *exc):
        if self._stack is not None:
            self._stack.pop()
            if self._start is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                _keep((self._name, self._parent, self._start, end))
        self._rf.__exit__(*exc)
        return False


def _open_spans():
    """This thread's stack of open span names (while a profiler records)."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _keep(record):
    global dropped
    with _lock:
        if len(_records) < MAX_RECORDS:
            _records.append(record)
        else:
            dropped += 1


def card_ms():
    """Each span name's card times (ms, in the order recorded): the time
    between its two CUDA events.  Synchronises once; {} when no span
    recorded events."""
    with _lock:
        records = list(_records)
    if not records:
        return {}
    torch.cuda.synchronize()
    out = {}
    for name, _, start, end in records:
        out.setdefault(name, []).append(start.elapsed_time(end))
    return out


def parents():
    """{span name: the name of the span it last opened inside, or None}."""
    with _lock:
        return {name: parent for name, parent, _, _ in _records}


def reset():
    """Forget every recorded event pair and the count of dropped ones."""
    global dropped
    with _lock:
        _records.clear()
        dropped = 0
