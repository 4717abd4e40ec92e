"""k1_roofline (%, device trace): the backward kernel K1's share of its
roofline in a batched solve: the least time an H100 could take for the
Riccati backward pass at the cell's shapes (the larger of its bytes over
3.35 TB/s and its operations over 67 TFLOP/s, float32) over the mean device
time of one K1 launch in the trace (kernels named ``riccati_backward*``).
The work is counted from the shapes, not from the kernel."""

from benchmark.peaks import bound_s

KERNEL_KEYS = ("riccati_backward",)


def riccati_work(Bt, N, nx, nu, invariant, elem_bytes=4):
    """(bytes, flops) the Riccati backward pass needs: each input read once,
    each output written once; the recursion's products, one factorisation
    and one substitution pair per stage.  The Qxu block of Q = H + Z^T P Z is
    never read by the recursion, so it is not counted.  (Frozen copy of
    ``chip_smoke.py``'s ``riccati_work``.)"""
    nz = nx + nu
    per_stage_elems = nz * nz + nz + nx + nu * nx + nu
    if not invariant:
        per_stage_elems += nx * nz
    total_elems = Bt * (N * per_stage_elems + nx * nx + nx)
    if invariant:
        total_elems += nx * nz
    per_stage_flops = (
        2 * nx * nx * nz  # P Z
        + 2 * nx * (nz * nz - nx * nu)  # Z^T (P Z) without the Qxu block
        + 2 * nx * nx + 2 * nz * nx  # P d, Z^T (p + P d)
        + nu**3 // 3  # factorisation of Quu
        + 2 * nu * nu * (nx + 1)  # forward and back substitution of [Qux | Qu]
        + 2 * nx * nx * nu + 2 * nx * nu  # Qux^T K, Qux^T kff
    )
    return elem_bytes * total_elems, Bt * N * per_stage_flops


def read(ctx):
    tr = ctx["trace"]
    if ctx["kind"] != "solve" or tr is None:
        return None
    times = tr.kernel_times(KERNEL_KEYS)
    if not times:
        return None
    d = ctx["dims"]
    nbytes, flops = riccati_work(ctx["batch"], d["N"], d["nx"], d["nu"], ctx["linear_dynamics"])
    bound, _ = bound_s(nbytes, flops, 4)
    return 100.0 * bound / (sum(times) / len(times))
