"""tick_ms_p90 (ms): 90th percentile of one tick's time over every tick of
the window.  A tick's time is the interval between CUDA events recorded on
the stream just before and just after the call of ``run`` that makes the
tick: the card's clock, no added synchronisation, a stall counts in full,
and what the harness does between ticks is left out."""

from benchmark.stats import percentile


def read(ctx):
    if ctx["kind"] != "loop" or not ctx["unit_s"]:
        return None
    return 1e3 * percentile(ctx["unit_s"], 90)
