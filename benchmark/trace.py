"""The traced part of a ``--trace 1`` run, and what the readers take from it.

``capture`` runs ``step`` a fixed number of times under ``torch.profiler``
(CPU and CUDA activities), inside one annotation ``bench.traced_window``
that ends with a synchronisation, and parses the exported Chrome trace into
a ``Trace``: every device interval (kernels, copies, sets), the host's
kernel-launch API calls made inside the program's calls (the spans
``bench.program`` that ``generator.py`` opens around them, so that the
harness's own launches are not counted), the host's operators, and the
window.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import tempfile

from benchmark import stats

WINDOW_SPAN = "bench.traced_window"
PROGRAM_SPAN = "bench.program"  # opened by generator.py around each call of the program
# the host-side calls that launch work on the device, each counted once
LAUNCH_NAMES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cudaGraphLaunch")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_OP_CATS = ("cpu_op",)
TOP = 10


@dataclasses.dataclass
class Trace:
    units: int  # calls or ticks traced
    window: tuple  # (start, end) in microseconds on the trace's clock
    kernels: list  # (name, start_us, dur_us), kernels only
    device: list  # (start_us, end_us) of every device interval
    launches: int  # host launch API calls inside the program's calls
    host_ops: list  # (name, start_us, end_us) of the host's operators

    @property
    def window_s(self):
        return (self.window[1] - self.window[0]) * 1e-6

    @property
    def busy_s(self):
        s, e = self.window
        return stats.covered([(max(a, s), min(b, e)) for a, b in self.device]) * 1e-6

    def kernel_times(self, keys):
        """Durations (s) of the kernels whose names hold one of ``keys``."""
        return [d * 1e-6 for n, _, d in self.kernels if any(k in n for k in keys)]

    def device_ops(self, top=TOP):
        """The kernels that took most device time: [[name, seconds], ...]."""
        tot = collections.Counter()
        for n, _, d in self.kernels:
            tot[n[:200]] += d * 1e-6
        return [[n, s] for n, s in tot.most_common(top)]

    def idle_gaps(self, top=TOP):
        """Idle device time in the window by what the host was doing then
        (the innermost host operator around each gap's middle):
        [[name, seconds], ...], largest first."""
        ops = sorted(self.host_ops, key=lambda o: (o[1], -o[2]))
        tot = collections.Counter()
        i, open_ops = 0, []  # a sweep over the nested operators
        for gs, ge in stats.gaps(self.device, *self.window):
            mid = 0.5 * (gs + ge)
            while i < len(ops) and ops[i][1] <= mid:
                while open_ops and open_ops[-1][2] < ops[i][1]:
                    open_ops.pop()
                open_ops.append(ops[i])
                i += 1
            while open_ops and open_ops[-1][2] < mid:
                open_ops.pop()
            name = open_ops[-1][0] if open_ops else "host outside any operator"
            tot[name[:200]] += (ge - gs) * 1e-6
        return [[n, s] for n, s in tot.most_common(top)]


def _spans(events, name):
    """(start, end) of every host annotation ``name``, in order."""
    return sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in events
                  if e.get("name") == name and e.get("ph") == "X"
                  and str(e.get("cat", "")).lower() == "user_annotation")


def parse(events, units):
    """A ``Trace`` of the Chrome-trace ``events`` (dicts with ph, cat, name,
    ts, dur), for ``units`` traced calls."""
    win = _spans(events, WINDOW_SPAN)
    if not win:
        raise ValueError(f"the trace has no {WINDOW_SPAN!r} span")
    w0, w1 = win[0]
    program = _spans(events, PROGRAM_SPAN)
    kernels, device, host_ops, launches = [], [], [], 0
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", "")).lower()
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        name = str(e.get("name", ""))
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur))
            if cat == "kernel" and w0 <= ts <= w1:
                kernels.append((name, ts, dur))
        elif cat in ("cuda_runtime", "cuda_driver"):
            if name in LAUNCH_NAMES and any(a <= ts <= b for a, b in program):
                launches += 1
        elif cat in HOST_OP_CATS:
            host_ops.append((name, ts, ts + dur))
    return Trace(units=units, window=(w0, w1), kernels=kernels, device=device,
                 launches=launches, host_ops=host_ops)


def capture(step, units):
    """Run ``step()`` ``units`` times under the profiler; returns a ``Trace``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            for _ in range(units):
                step()
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return parse(events, units)
