"""balance_ms.solve (ms, device trace): the card's time a call in the balance
rows, read from the program's span ``ocp.balance`` (the contact forces'
expansion and the objects' wrench balances in the equality rows, the
friction cones in the inequality rows; under ``jacfwd`` each occurrence
holds the rows' primal and tangent kernels, in the linearization and in
every line-search merit): the time between its two CUDA events, summed over
its occurrences in the traced units, over their number.  None where the
program has no such span."""

from benchmark import spans


def read(ctx):
    if ctx["kind"] != "solve":
        return None
    return spans.card_ms(ctx["trace"], "ocp.balance")
