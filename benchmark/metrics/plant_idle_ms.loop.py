"""plant_idle_ms.loop (ms, device trace): the card's idle time a tick while the
host is in the plant step, read from the program's span ``loop.plant`` (the
policy, the command integration, the plant step with P1, the EE pose after
it): the gaps between the device's intervals in the traced window whose
midpoint falls inside the span on the host, summed, over the traced units.
None where the program has no such span."""

from benchmark import spans


def read(ctx):
    if ctx["kind"] != "loop":
        return None
    return spans.idle_ms(ctx["trace"], "loop.plant")
