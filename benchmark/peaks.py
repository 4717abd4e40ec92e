"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates), the yardstick of every roofline share.  They assume the card's full
700 W; the run prints the card's power limit beside each share."""

H100_BYTES_PER_S = 3.35e12  # HBM3
H100_FP32_FLOPS = 67e12  # float32 outside the tensor cores
H100_FP64_FLOPS = 67e12  # float64 through the tensor cores
FLOPS = {4: H100_FP32_FLOPS, 8: H100_FP64_FLOPS}


def bound_s(nbytes, flops, elem_bytes=4):
    """(seconds, "bytes" | "operations"): the least time the card could
    take, the larger of bytes over bandwidth and operations over peak."""
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = flops / FLOPS[elem_bytes]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
