"""plant_ms.loop (ms, device trace): the card's time a tick in the plant step,
read from the program's span ``loop.plant`` (the policy, the command
integration, the plant step with P1, the EE pose after it): the time between
its two CUDA events, summed over its occurrences in the traced units, over
their number.  None where the program has no such span."""

from benchmark import spans


def read(ctx):
    if ctx["kind"] != "loop":
        return None
    return spans.card_ms(ctx["trace"], "loop.plant")
