"""launches_per_tick (launches/tick, device trace): the host's kernel-launch API calls in the
profiler's trace (cudaLaunchKernel, cudaLaunchKernelExC, cuLaunchKernel,
cudaGraphLaunch, each counted once) over the ticks traced.  An exact count: it
falls with fusion and with graph capture."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["kind"] != "loop" or tr is None or tr.units == 0 or tr.launches == 0:
        return None
    return tr.launches / tr.units
