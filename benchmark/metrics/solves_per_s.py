"""solves_per_s (solves/s, host clock): instance-solves completed in the
window over the window's seconds (B x calls / seconds, the window closed by a
synchronisation)."""

from benchmark.stats import rate


def read(ctx):
    if ctx["kind"] != "solve":
        return None
    return rate(ctx["batch"] * ctx["units"], ctx["window_s"])
