"""p1_roofline (%, device trace): the plant kernel P1's share of its
roofline in a closed-loop tick: the least time an H100 could take for one
plant step of the cell's batch (the larger of its bytes over 3.35 TB/s and its
operations over 67 TFLOP/s, float32) over the mean device time of one P1
launch in the trace (kernels named ``plant_kernel``).  The shapes (objects,
contact slots, anchors, substeps) are read from the configuration through
the reference's plant; the work is counted from them, not from the kernel."""

from benchmark.peaks import bound_s

KERNEL_KEYS = ("plant_kernel",)
# packed widths of the plant's inputs (frozen copy of sim/contact.py's)
FRAME_DIM = 24  # R (9), p, v, w, a, al of the EE at one outer step
SLOT_GEOM_DIM = 18  # point 3, normal 3, tangents 2x3, half extents 2, max depth, vertex 3
OBJ_DATA_DIM = 5  # n_eff, largest squared vertex lever, nominal CoM in the EE frame 3


def plant_work(n_obj, n_slots, s_max, k_max, stiction, n_sub, B, n_steps, elem_bytes):
    """(bytes, operations) of one plant step: each input read once and each
    output written once; the floating-point operations each substep needs,
    counted once per instance (the tray frame: about 130), per slot (about
    250 under stiction, 205 regularized) and per object (about 330), square
    roots, divisions and sines as one each.  (Frozen copy of
    ``sim/contact.py``'s ``plant_work``, which ``chip_smoke.py`` uses.)"""
    n_anchor = n_obj * s_max * k_max if stiction else 0
    state = n_obj * 13 + 2 * n_anchor
    per_instance = n_steps * FRAME_DIM + n_obj * (1 + 9 + 1 + 3) + 2 * state
    tables_elems = n_slots * (SLOT_GEOM_DIM + 4) + n_obj * (OBJ_DATA_DIM + 2)
    flags = B * 2 * (n_anchor + n_obj)
    nbytes = elem_bytes * (B * per_instance + tables_elems) + flags
    per_slot = 250 if stiction else 205
    per_substep = 130 + n_slots * per_slot + n_obj * 330
    return nbytes, B * n_steps * n_sub * per_substep


def plant_shape(conf, ctrl_rate):
    """(n_obj, n_slots, s_max, k_max, stiction, n_sub, n_steps) of the
    configuration's plant, from the reference's own build of it."""
    import torch

    from benchmark.reference.sim.simulation import UprightSimulation

    sim = UprightSimulation(conf["simulation"], device="cpu", dtype=torch.float64)
    t, c = sim.tables, sim.contact
    n_steps = max(1, int(round(1.0 / ctrl_rate / sim.timestep)))
    return t.n_obj, t.n_slots, t.s_max, t.k_max, bool(c.stiction), int(c.n_sub), n_steps


def read(ctx):
    tr = ctx["trace"]
    if ctx["kind"] != "loop" or tr is None:
        return None
    times = tr.kernel_times(KERNEL_KEYS)
    if not times:
        return None
    shape = plant_shape(ctx["config"]["config"], float(ctx["traffic"]["ctrl_rate"]))
    nbytes, flops = plant_work(*shape, ctx["batch"], 4)
    bound, _ = bound_s(nbytes, flops, 4)
    return 100.0 * bound / (sum(times) / len(times))
