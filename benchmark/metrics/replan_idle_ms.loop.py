"""replan_idle_ms.loop (ms, device trace): the card's idle time a tick while the
host is in the closed loop's replan, read from the program's span
``loop.replan`` (observe, shift and heal the warm start, the stage parameters,
the solve): the gaps between the device's intervals in the traced window whose
midpoint falls inside the span on the host, summed, over the traced units.
None where the program has no such span."""

from benchmark import spans


def read(ctx):
    if ctx["kind"] != "loop":
        return None
    return spans.idle_ms(ctx["trace"], "loop.replan")
