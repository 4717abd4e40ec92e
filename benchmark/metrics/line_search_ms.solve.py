"""line_search_ms.solve (ms, device trace): the card's time a call in the
solver's line search, read from the program's span ``al.line_search`` (the
candidates' rollouts and merits, the incoming merit, argmin, accept and the
selects): the time between its two CUDA events, summed over its occurrences in
the traced units, over their number.  None where the program has no such span."""

from benchmark import spans


def read(ctx):
    if ctx["kind"] != "solve":
        return None
    return spans.card_ms(ctx["trace"], "al.line_search")
