"""device_idle_pct.loop (%, device trace): share of the traced window in which
no kernel, copy or set runs on the card: one minus the union of the device's
intervals (not a sum of kernel times) over the window."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["kind"] != "loop" or tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
