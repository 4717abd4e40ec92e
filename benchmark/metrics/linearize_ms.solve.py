"""linearize_ms.solve (ms, device trace): the card's time a call in the solver's
linearization, read from the program's span ``al.linearize`` (pin x0, the
dynamics Jacobians, the defects, the AL stage and final derivatives): the time
between its two CUDA events, summed over its occurrences in the traced units,
over their number.  None where the program has no such span."""

from benchmark import spans


def read(ctx):
    if ctx["kind"] != "solve":
        return None
    return spans.card_ms(ctx["trace"], "al.linearize")
