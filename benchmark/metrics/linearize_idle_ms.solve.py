"""linearize_idle_ms.solve (ms, device trace): the card's idle time a call while
the host is in the solver's linearization, read from the program's span
``al.linearize`` (pin x0, the dynamics Jacobians, the defects, the AL stage
and final derivatives): the gaps between the device's intervals in the traced
window whose midpoint falls inside the span on the host, summed, over the
traced units.  None where the program has no such span."""

from benchmark import spans


def read(ctx):
    if ctx["kind"] != "solve":
        return None
    return spans.idle_ms(ctx["trace"], "al.linearize")
