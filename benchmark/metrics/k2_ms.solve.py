"""k2_ms.solve (ms, device trace): the card's time a call in kernel K2, the
kinematic chain's sweep and its Jacobian (``upright_tpu_torch/csrc/chain.cu``,
kernels named ``k2_chain*``): the device time of its launches in the traced
units, summed, over their number.  None where the program launches no such
kernel."""

KERNEL_KEYS = ("k2_chain",)


def read(ctx):
    tr = ctx["trace"]
    if ctx["kind"] != "solve" or tr is None:
        return None
    times = tr.kernel_times(KERNEL_KEYS)
    if not times:
        return None
    return 1e3 * sum(times) / tr.units
