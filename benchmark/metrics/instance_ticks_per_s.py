"""instance_ticks_per_s (ticks/s, host clock): closed-loop instance-ticks
completed in the window over the window's seconds (B x ticks / seconds)."""

from benchmark.stats import rate


def read(ctx):
    if ctx["kind"] != "loop":
        return None
    return rate(ctx["batch"] * ctx["units"], ctx["window_s"])
