"""line_search_idle_ms.solve (ms, device trace): the card's idle time a call
while the host is in the solver's line search, read from the program's span
``al.line_search`` (the candidates' rollouts and merits, the incoming merit,
argmin, accept and the selects): the gaps between the device's intervals in
the traced window whose midpoint falls inside the span on the host, summed,
over the traced units.  None where the program has no such span."""

from benchmark import spans


def read(ctx):
    if ctx["kind"] != "solve":
        return None
    return spans.idle_ms(ctx["trace"], "al.line_search")
