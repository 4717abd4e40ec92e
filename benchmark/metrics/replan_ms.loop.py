"""replan_ms.loop (ms, device trace): the card's time a tick in the closed loop's
replan, read from the program's span ``loop.replan`` (observe, shift and heal
the warm start, the stage parameters, the solve): the time between its two
CUDA events, summed over its occurrences in the traced units, over their
number.  None where the program has no such span."""

from benchmark import spans


def read(ctx):
    if ctx["kind"] != "loop":
        return None
    return spans.card_ms(ctx["trace"], "loop.replan")
