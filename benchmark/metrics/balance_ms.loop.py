"""balance_ms.loop (ms, device trace): the card's time a tick in the balance
rows, read from the program's span ``ocp.balance`` (the contact forces'
expansion and the objects' wrench balances in the equality rows, the
friction cones in the inequality rows, wherever the replan evaluates or
differentiates them): the time between its two CUDA events, summed over its
occurrences in the traced units, over their number.  None where the program
has no such span."""

from benchmark import spans


def read(ctx):
    if ctx["kind"] != "loop":
        return None
    return spans.card_ms(ctx["trace"], "ocp.balance")
