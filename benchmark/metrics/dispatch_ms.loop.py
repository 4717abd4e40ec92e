"""dispatch_ms.loop (ms, host clock): the host's time from the call into the
program's unit (the device loop's run(carry, 1, target)) to
its return, before any synchronisation, averaged over the window's units:
the host's enqueue, which paces the card when the card waits for it."""


def read(ctx):
    if ctx["kind"] != "loop" or not ctx["dispatch_s"]:
        return None
    return 1e3 * sum(ctx["dispatch_s"]) / len(ctx["dispatch_s"])
