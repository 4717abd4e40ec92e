"""Scripts around the port's kernels: timing on the card, emulation on the CPU."""
