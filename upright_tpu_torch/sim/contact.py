"""The plant's contact substeps: CUDA kernel P1, its wrapper and plain version.

One call advances the balanced objects through every inner substep of one
``UprightSimulation.step``: ``n_steps`` outer steps of the robot, each cut
into ``n_sub`` object substeps, over which the tray frame is propagated from
the outer step's EE motion.  It carries the semantics of
``upright_tpu/sim/simulation.py`` ``_step_impl``'s object branch (:337-376)
and ``_object_substep`` (:390-644):

  - penalty normal forces with prefiltered (semi-implicit) damping;
  - stiction (anchor springs clamped to the cone, anchors dragged) or
    regularized Coulomb friction;
  - per-object stability caps on the contact gains;
  - object-on-object reactions;
  - semi-implicit Euler with the world-frame inertia solve;
  - the divergence freeze and its latch.

The JAX package gets this loop from XLA's fusion of a ``lax.scan``; eagerly,
one substep is about a thousand tensor operations, so the port runs the whole
loop as one hand-written kernel (``csrc/plant.cu``, no Pallas counterpart).

``advance_objects`` is what the plant calls.  For CUDA tensors it launches the
kernel or raises: there is no fallback on the card.  For CPU tensors, and
only then, it runs ``advance_objects_plain``, the same loop in PyTorch
(batched over instances and contact slots, a Python loop over substeps),
which the CPU tests use and which the kernel is held against on the card.

Layout.  A contact *slot* is one (object, surface, vertex) triple; slots are
ordered by object, then surface, then vertex, as the reference loops.  The
anchors of the stiction model are one padded tensor
``(B, n_obj, s_max, k_max, 2)`` with a validity mask ``(B, n_obj, s_max,
k_max)``; entries past an object's surface or vertex count are never touched.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from upright_tpu_torch._build import load_library
from upright_tpu_torch.core.math import cross, matvec, quat_integrate, quat_to_rot, skew3

# Kernel limits: one block holds one instance, one thread per slot.
MAX_SLOTS = 256
MAX_OBJECTS = 32
WARP = 32

# Columns of the tables
FRAME_DIM = 24  # R (9, row-major), p, v, w, a, al of the EE at one outer step
SLOT_GEOM_DIM = 18  # point 3, normal 3, tangents 2x3, half extents 2, max depth, vertex 3
OBJ_DATA_DIM = 5  # n_eff, L2 (largest squared vertex lever), nominal CoM in the EE frame 3

_ELEM_BYTES = {torch.float32: 4, torch.float64: 8}

# Number of kernel launches made by `advance_objects` (CUDA path only).
launch_count = 0


@dataclasses.dataclass(frozen=True)
class PlantConstants:
    """The plant's scalar settings, as ``UprightSimulation`` derives them."""

    gravity: tuple
    k_contact: float
    c_contact: float
    v_slip: float
    max_contact_force: float
    divergence_freeze: float
    dt_obj: float
    n_sub: int
    stiction: bool


def piece_tables(slot_int, n_obj):
    """The kernel's sums, planned on the host: (slot_piece, obj_rows,
    n_rows, max_piece) for a slot table (n_slots, 4) in slot order.

    A *piece* is a run of slots of one object and one surface inside one
    warp of 32 (one parent, so one reaction).  The kernel sums each piece
    across its lanes and its first lane writes the sum (force, torque) to a
    *row* of the object and, when the surface is an object's, the reaction
    (minus the force, the torque about the parent) to a row of the parent.
    Each object's rows are one contiguous range, so its integrating lane
    adds ``obj_rows[i, 1]`` rows from ``obj_rows[i, 0]``.

    slot_piece (n_slots, 3) int32: last slot of the slot's piece; for a
    piece's first slot its own row and its reaction row (-1: on the EE), -1
    and -1 for the others.  obj_rows (n_obj, 2) int32: first row, count.
    """
    slot_int = np.asarray(slot_int, dtype=np.int64).reshape(-1, 4)
    n = len(slot_int)
    key = [(int(o), int(sf), int(p)) for o, p, sf, _v in slot_int]
    heads = [s for s in range(n) if s == 0 or s % WARP == 0 or key[s] != key[s - 1]]
    slot_piece = np.full((n, 3), -1, dtype=np.int32)
    for h, nxt in zip(heads, heads[1:] + [n]):
        slot_piece[h:nxt, 0] = nxt - 1
    rows = [[] for _ in range(n_obj)]  # per object: (head, column of slot_piece)
    for h in heads:
        rows[key[h][0]].append((h, 1))
    for h in heads:
        if key[h][2] >= 0:
            rows[key[h][2]].append((h, 2))
    obj_rows = np.zeros((n_obj, 2), dtype=np.int32)
    n_rows = 0
    for i, entries in enumerate(rows):
        obj_rows[i] = (n_rows, len(entries))
        for h, col in entries:
            slot_piece[h, col] = n_rows
            n_rows += 1
    max_piece = max((nxt - h for h, nxt in zip(heads, heads[1:] + [n])), default=1)
    return slot_piece, obj_rows, n_rows, max_piece


@dataclasses.dataclass(frozen=True)
class ContactTables:
    """Contact slots and per-object data of one arrangement, on one device.

    The piece tables (see ``piece_tables``) are made from ``slot_int`` when
    they are not given."""

    n_obj: int
    s_max: int
    k_max: int
    slot_int: torch.Tensor  # (n_slots, 4) int32: object, parent (-1 = EE), surface, vertex
    slot_geom: torch.Tensor  # (n_slots, SLOT_GEOM_DIM)
    obj_int: torch.Tensor  # (n_obj, 2) int32: first slot, slot count
    obj_data: torch.Tensor  # (n_obj, OBJ_DATA_DIM)
    slot_piece: torch.Tensor = None  # (n_slots, 3) int32
    obj_rows: torch.Tensor = None  # (n_obj, 2) int32
    n_rows: int = 0
    max_piece: int = 1
    has_reactions: bool = False  # some slot rests on another object

    def __post_init__(self):
        # made on the host, once: a launch reads nothing back from the card
        if self.slot_piece is None:
            slot_int = self.slot_int.cpu().numpy()
            slot_piece, obj_rows, n_rows, max_piece = piece_tables(slot_int, self.n_obj)
            dev = self.slot_int.device
            for name, value in (
                ("slot_piece", torch.as_tensor(slot_piece, device=dev)),
                ("obj_rows", torch.as_tensor(obj_rows, device=dev)),
                ("n_rows", n_rows), ("max_piece", max_piece),
                ("has_reactions", bool((slot_int[:, 1] >= 0).any())),
            ):
                object.__setattr__(self, name, value)

    @property
    def n_slots(self):
        return self.slot_int.shape[0]

    @staticmethod
    def from_specs(specs, device, dtype):
        """Tables of a list of ``SimObjectSpec`` (see ``sim/simulation.py``)."""
        slot_int, slot_geom, obj_int, obj_data = [], [], [], []
        for i, sp in enumerate(specs):
            V = np.asarray(sp.vertices_local, dtype=float)
            obj_int.append([len(slot_int), len(sp.surfaces) * len(V)])
            obj_data.append([max(1, len(V) // 2), float(np.max(np.sum(V**2, axis=1))),
                             *np.asarray(sp.com_world_ee, dtype=float)])
            for si, surf in enumerate(sp.surfaces):
                T = np.asarray(surf.tangents, dtype=float)
                for vi, vert in enumerate(V):
                    slot_int.append([i, surf.parent, si, vi])
                    slot_geom.append([*surf.point, *surf.normal, *T[0], *T[1],
                                      *surf.half_extents, surf.max_depth, *vert])
        s_max = max((len(sp.surfaces) for sp in specs), default=0)
        k_max = max((len(sp.vertices_local) for sp in specs), default=0)

        def ints(a, cols):
            return torch.as_tensor(np.asarray(a, dtype=np.int32).reshape(-1, cols), device=device)

        def floats(a, cols):
            return torch.as_tensor(np.asarray(a, dtype=float).reshape(-1, cols),
                                   dtype=dtype, device=device)

        return ContactTables(
            n_obj=len(specs), s_max=s_max, k_max=k_max,
            slot_int=ints(slot_int, 4), slot_geom=floats(slot_geom, SLOT_GEOM_DIM),
            obj_int=ints(obj_int, 2), obj_data=floats(obj_data, OBJ_DATA_DIM),
        )

    def to(self, device=None, dtype=None):
        """The same tables on another device or in another float dtype."""
        return dataclasses.replace(
            self,
            slot_int=self.slot_int.to(device=device), obj_int=self.obj_int.to(device=device),
            slot_piece=self.slot_piece.to(device=device), obj_rows=self.obj_rows.to(device=device),
            slot_geom=self.slot_geom.to(device=device, dtype=dtype),
            obj_data=self.obj_data.to(device=device, dtype=dtype),
        )


def pack_frames(f):
    """FrameMotion with leading axes (...) -> (..., FRAME_DIM)."""
    return torch.cat([f.R.flatten(-2), f.p, f.v, f.w, f.a, f.al], dim=-1)


def substep_offsets(n_sub, dt_obj):
    """(tau * dt_obj, 0.5 * (tau * dt_obj)^2) for tau = 0 .. n_sub - 1.

    The reference scans tau as float32 and multiplies it by a Python number,
    which keeps the product float32, and so is 0.5 * dto * dto; both enter
    the float64 frame propagation with float32 values.  The kernel rounds
    the same way."""
    tau = np.arange(n_sub, dtype=np.float32)
    dto = tau * np.float32(dt_obj)
    return dto.astype(np.float64), ((np.float32(0.5) * dto) * dto).astype(np.float64)


def contact_gains(tables, consts, mass, inertia):
    """Per-object stability-capped contact gains (k, c) and the clamped
    smallest principal inertia, from the runtime parameters (B, n_obj)."""
    dt = consts.dt_obj
    L2 = tables.obj_data[:, 1]
    I_min = torch.clamp(inertia.diagonal(dim1=-2, dim2=-1).amin(-1), min=1e-12)
    m_eff = 1.0 / (1.0 / mass + L2 / I_min)
    omega_max = 0.3 / dt
    k = torch.clamp(m_eff * omega_max**2, max=consts.k_contact)
    c = torch.minimum(torch.clamp(2.0 * torch.sqrt(k * mass), max=consts.c_contact),
                      0.3 * m_eff / dt)
    return k, c, I_min


def plant_params_for_batch(params, batch):
    """Plant parameters with a leading instance axis of ``batch``: leaves of
    one instance (mass (n_obj,) ...) are expanded, batched leaves are kept."""
    ndim = {"mass": 1, "inertia": 3, "mu": 1, "com_offset": 2}
    out = {}
    for name, n in ndim.items():
        t = params[name]
        if t.ndim == n:
            t = t.expand((batch,) + tuple(t.shape))
        elif t.ndim != n + 1 or t.shape[0] != batch:
            raise ValueError(f"params[{name!r}] has shape {tuple(t.shape)} for a batch of {batch}")
        out[name] = t
    return out


def _rot_exp(w, dt):
    """exp([w dt]x) via Rodrigues, safe as |w| -> 0; w (B, 3)."""
    nw = torch.sqrt((w * w).sum(-1, keepdim=True))
    th = (nw * dt).unsqueeze(-1)
    K = skew3(w / torch.clamp(nw, min=1e-12))
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + torch.sin(th) * K + (1.0 - torch.cos(th)) * (K @ K)


def _object_substep(tables, consts, idx, ee, state, prm, dt):
    """One substep of every object of every instance (the reference's
    ``_object_substep``, over contact slots instead of a loop per object)."""
    r, q, v, w, anchors, valid, div = state
    mass, inertia, mu, com_off, k, c, I_min = prm
    R_ee, p_ee, v_ee, w_ee = ee
    obj, par, sel_r, par_r = idx
    g = tables.slot_geom
    n_eff = tables.obj_data[obj, 0]

    R_obj = quat_to_rot(q)  # (B, n_obj, 3, 3)
    # parent of each slot: an object, or the EE (index n_obj)
    R_all = torch.cat([R_obj, R_ee[:, None]], dim=1)
    r_all = torch.cat([r, p_ee[:, None]], dim=1)
    v_all = torch.cat([v, v_ee[:, None]], dim=1)
    w_all = torch.cat([w, w_ee[:, None]], dim=1)
    R_p, r_p, v_p, w_p = R_all[:, par], r_all[:, par], v_all[:, par], w_all[:, par]

    n_w = matvec(R_p, g[:, 3:6])
    p_surf = r_p + matvec(R_p, g[:, 0:3])
    t1_w, t2_w = matvec(R_p, g[:, 6:9]), matvec(R_p, g[:, 9:12])

    r_i = r[:, obj]
    p_w = r_i + matvec(R_obj[:, obj], g[:, 15:18] - com_off[:, obj])
    rel = p_w - p_surf
    delta = -(rel * n_w).sum(-1)
    t_coords = torch.stack([(rel * t1_w).sum(-1), (rel * t2_w).sum(-1)], dim=-1)
    inside = (torch.abs(t_coords) <= g[:, 12:14] + 1e-3).all(-1)
    in_contact = (delta > 0.0) & (delta <= g[:, 14]) & inside

    lever = p_w - r_i
    v_rel = v[:, obj] + cross(w[:, obj], lever) - (v_p + cross(w_p, p_w - r_p))
    v_n = (v_rel * n_w).sum(-1)
    v_t = v_rel - v_n.unsqueeze(-1) * n_w

    w_v = 1.0 / mass[:, obj] + (lever**2).sum(-1) / I_min[:, obj]

    def prefilter(gain_v):
        return gain_v / (1.0 + dt * gain_v * n_eff * w_v)

    k_i, mu_i = k[:, obj], mu[:, obj]
    c_v = prefilter(c[:, obj])
    f_n = torch.clamp(k_i * delta - c_v * v_n, min=0.0)
    f_n = torch.clamp(f_n, max=consts.max_contact_force)
    f_n = torch.where(in_contact, f_n, torch.zeros_like(f_n))

    if consts.stiction:
        s_i, v_i = tables.slot_int[:, 2].long(), tables.slot_int[:, 3].long()
        anchor = anchors[:, obj, s_i, v_i]  # (B, n_slots, 2)
        stuck = valid[:, obj, s_i, v_i] & in_contact
        d_t = t_coords - torch.where(stuck.unsqueeze(-1), anchor, t_coords)
        F_spring = -(d_t[..., 0:1] * t1_w + d_t[..., 1:2] * t2_w) * k_i.unsqueeze(-1)
        F_t = F_spring - c_v.unsqueeze(-1) * v_t
        F_mag = torch.sqrt((F_t * F_t).sum(-1))
        scale = torch.clamp(mu_i * f_n / torch.clamp(F_mag, min=1e-12), max=1.0)
        F_t = F_t * scale.unsqueeze(-1)
        f_c = f_n.unsqueeze(-1) * n_w + torch.where(in_contact.unsqueeze(-1), F_t,
                                                    torch.zeros_like(F_t))
        d_norm = torch.sqrt((d_t * d_t).sum(-1))
        d_max = torch.clamp(mu_i * torch.clamp(delta, min=0.0), min=1e-4)
        d_new = d_t * torch.clamp(d_max / torch.clamp(d_norm, min=1e-12), max=1.0).unsqueeze(-1)
        anchors = anchors.clone()
        valid = valid.clone()
        anchors[:, obj, s_i, v_i] = torch.where(in_contact.unsqueeze(-1), t_coords - d_new,
                                                t_coords)
        valid[:, obj, s_i, v_i] = in_contact
    else:
        v_t_norm = torch.sqrt((v_t * v_t).sum(-1)) + consts.v_slip
        gain = prefilter(mu_i * f_n / v_t_norm)
        f_c = f_n.unsqueeze(-1) * n_w - gain.unsqueeze(-1) * v_t

    # totals per object, then Newton's third law on the supporting objects
    grav = torch.as_tensor(consts.gravity, dtype=r.dtype, device=r.device)
    F = (mass.unsqueeze(-1) * grav).index_add(1, obj, f_c)
    T = torch.zeros_like(F).index_add(1, obj, cross(lever, f_c))
    if sel_r.numel():
        f_r = f_c[:, sel_r]
        F = F.index_add(1, par_r, -f_r)
        T = T.index_add(1, par_r, cross(p_w[:, sel_r] - r[:, par_r], -f_r))

    # semi-implicit Euler
    v_new = v + dt * F / mass.unsqueeze(-1)
    I_w = R_obj @ inertia @ R_obj.transpose(-1, -2)
    w_dot = torch.linalg.solve(I_w, (T - cross(w, matvec(I_w, w))).unsqueeze(-1)).squeeze(-1)
    w_new = w + dt * w_dot
    r_new = r + dt * v_new
    q_new = quat_integrate(q, w_new, dt)

    if consts.divergence_freeze > 0:
        r_oe = (r - p_ee[:, None]) @ R_ee  # rows = R_we^T (r_i - r_ew)
        disp = torch.sqrt(((r_oe - tables.obj_data[:, 2:5]) ** 2).sum(-1))
        finite = (torch.isfinite(r_new).all(-1) & torch.isfinite(v_new).all(-1)
                  & torch.isfinite(w_new).all(-1) & torch.isfinite(q_new).all(-1))
        if div is not None:
            div = div | ~finite
        hold = ((disp > consts.divergence_freeze) | ~finite).unsqueeze(-1)
        r_new = torch.where(hold, r, r_new)
        q_new = torch.where(hold, q, q_new)
        v_new = torch.where(hold, torch.zeros_like(v_new), v_new)
        w_new = torch.where(hold, torch.zeros_like(w_new), w_new)
    return r_new, q_new, v_new, w_new, anchors, valid, div


def advance_objects_plain(tables: ContactTables, consts: PlantConstants, frames, objects, params):
    """Plain PyTorch version of the kernel.

    frames: (B, n_steps, FRAME_DIM), the EE motion at the start of each outer
    step; objects: ``ObjectsState`` with leading axis B; params: the plant's
    runtime parameters (see ``UprightSimulation.default_params``), of one
    instance or batched.  Returns the new ``ObjectsState``.
    """
    B, n_steps, _ = frames.shape
    prm = plant_params_for_batch(params, B)
    k, c, I_min = contact_gains(tables, consts, prm["mass"], prm["inertia"])
    prm = (prm["mass"], prm["inertia"], prm["mu"], prm["com_offset"], k, c, I_min)
    obj = tables.slot_int[:, 0].long()
    parent = tables.slot_int[:, 1].long()
    sel_r = torch.nonzero(parent >= 0).flatten()
    idx = (obj, torch.where(parent < 0, tables.n_obj, parent), sel_r, parent[sel_r])
    dtos, half_dto2 = substep_offsets(consts.n_sub, consts.dt_obj)

    state = (objects.r, objects.q, objects.v, objects.w, objects.anchors,
             objects.anchor_valid, objects.diverged)
    for s in range(n_steps):
        f = frames[:, s]
        R0, p0, v0, w0 = f[:, 0:9].unflatten(-1, (3, 3)), f[:, 9:12], f[:, 12:15], f[:, 15:18]
        a0, al0 = f[:, 18:21], f[:, 21:24]
        for tau in range(consts.n_sub):
            dto, h = float(dtos[tau]), float(half_dto2[tau])
            ee = (_rot_exp(w0, dto) @ R0, p0 + dto * v0 + h * a0, v0 + dto * a0, w0 + dto * al0)
            state = _object_substep(tables, consts, idx, ee, state, prm, consts.dt_obj)
    r, q, v, w, anchors, valid, div = state
    return objects.replace(r=r, q=q, v=v, w=w, anchors=anchors, anchor_valid=valid, diverged=div)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


class _PlantArgs(ctypes.Structure):
    """Mirror of ``PlantArgs`` in csrc/plant.cu."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in (
            "frames", "slot_geom", "slot_int", "obj_data", "obj_int",
            "mass", "inertia", "mu", "com_offset",
            "r", "q", "v", "w", "anchors", "anchor_valid", "diverged",
            "r_out", "q_out", "v_out", "w_out", "anchors_out", "anchor_valid_out",
            "diverged_out")]
        + [("gravity", ctypes.c_double * 3)]
        + [(n, ctypes.c_double) for n in (
            "k_contact", "c_contact", "v_slip", "max_force", "freeze", "dt_obj")]
        + [(n, ctypes.c_int) for n in (
            "batch", "n_steps", "n_sub", "n_obj", "n_slots", "s_max", "k_max",
            "stiction", "has_diverged")]
        + [("slot_piece", ctypes.c_void_p), ("obj_rows", ctypes.c_void_p)]
        + [(n, ctypes.c_int) for n in ("n_rows", "max_piece", "has_reactions")]
    )


# The kernel's instantiations, in the order of plant.cu's instance(): one warp
# (at most 32 slots) or block-wide, stiction or regularized friction
INSTANCES = tuple(f"{t}{route}{friction}" for friction in ("", " regularized")
                  for route in ("", " block-wide") for t in ("float32", "float64"))

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = load_library("plant")
        lib.plant_advance.argtypes = [ctypes.POINTER(_PlantArgs), ctypes.c_int, ctypes.c_void_p]
        lib.plant_advance.restype = ctypes.c_int
        lib.plant_instance_attrs.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.plant_instance_attrs.restype = ctypes.c_int
        lib.plant_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.plant_smem_bytes.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def instance_attrs():
    """Registers per thread, bytes of local memory per thread and bytes of
    static shared memory of each instantiation of the kernel, by name."""
    lib = _library()
    out = {}
    for which, name in enumerate(INSTANCES):
        buf = (ctypes.c_int * 3)()
        err = lib.plant_instance_attrs(which, buf)
        if err != 0:
            raise RuntimeError(f"cudaFuncGetAttributes failed for {name} with CUDA error {err}")
        out[name] = {"registers": buf[0], "local_bytes": buf[1], "static_smem_bytes": buf[2]}
    return out


def _advance_objects_cuda(tables, consts, frames, objects, params):
    global launch_count
    dtype = frames.dtype
    if dtype not in _ELEM_BYTES:
        raise TypeError(f"frames are {dtype}; the plant kernel takes float32 or float64")
    if frames.ndim != 3 or frames.shape[-1] != FRAME_DIM:
        raise ValueError(f"frames must be (B, n_steps, {FRAME_DIM}); got {tuple(frames.shape)}")
    B, n_steps, _ = frames.shape
    n_obj, n_slots = tables.n_obj, tables.n_slots
    if not 1 <= n_obj <= MAX_OBJECTS:
        raise ValueError(f"{n_obj} objects: the plant kernel takes 1 to {MAX_OBJECTS}")
    if n_slots > MAX_SLOTS:
        raise ValueError(f"{n_slots} contact slots: the plant kernel takes at most {MAX_SLOTS} "
                         "(one thread per slot in one block)")
    prm = plant_params_for_batch(params, B)
    floats = {"frames": frames, "slot_geom": tables.slot_geom, "obj_data": tables.obj_data,
              **prm, "r": objects.r, "q": objects.q, "v": objects.v, "w": objects.w}
    if consts.stiction:
        if objects.anchors is None or objects.anchor_valid is None:
            raise ValueError("the stiction model needs anchors and anchor_valid in the state")
        floats["anchors"] = objects.anchors
    shapes = {"r": (B, n_obj, 3), "q": (B, n_obj, 4), "v": (B, n_obj, 3), "w": (B, n_obj, 3),
              "mass": (B, n_obj), "inertia": (B, n_obj, 3, 3), "mu": (B, n_obj),
              "com_offset": (B, n_obj, 3),
              "anchors": (B, n_obj, tables.s_max, tables.k_max, 2)}
    for name, t in floats.items():
        if not t.is_cuda or t.device != frames.device:
            raise ValueError(f"{name} is on {t.device}; every input must be on {frames.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype} and frames are {dtype}; the plant kernel "
                            "takes all its inputs in one dtype")
        if name in shapes and tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} must be {shapes[name]}; got {tuple(t.shape)}")
    floats = {n: t.contiguous() for n, t in floats.items()}
    masks = {}
    if consts.stiction:
        masks["anchor_valid"] = objects.anchor_valid.to(torch.uint8).contiguous()
    if objects.diverged is not None:
        masks["diverged"] = objects.diverged.to(torch.uint8).contiguous()
    for name, t in masks.items():
        if t.device != frames.device:
            raise ValueError(f"{name} is on {t.device}; every input must be on {frames.device}")
    ints = {"slot_int": tables.slot_int, "obj_int": tables.obj_int,
            "slot_piece": tables.slot_piece, "obj_rows": tables.obj_rows}
    for name, t in ints.items():
        if t.device != frames.device or t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32 on {frames.device}")

    out = {n: torch.empty_like(floats[n]) for n in ("r", "q", "v", "w")}
    if consts.stiction:
        out["anchors"] = floats["anchors"].clone()  # padding entries pass through
        out["anchor_valid"] = masks["anchor_valid"].clone()
    if "diverged" in masks:
        out["diverged"] = torch.empty_like(masks["diverged"])

    def ptr(d, name):
        return d[name].data_ptr() if name in d else None

    args = _PlantArgs(
        frames=ptr(floats, "frames"), slot_geom=ptr(floats, "slot_geom"),
        slot_int=ptr(ints, "slot_int"), obj_data=ptr(floats, "obj_data"),
        obj_int=ptr(ints, "obj_int"), mass=ptr(floats, "mass"),
        inertia=ptr(floats, "inertia"), mu=ptr(floats, "mu"),
        com_offset=ptr(floats, "com_offset"), r=ptr(floats, "r"), q=ptr(floats, "q"),
        v=ptr(floats, "v"), w=ptr(floats, "w"), anchors=ptr(floats, "anchors"),
        anchor_valid=ptr(masks, "anchor_valid"), diverged=ptr(masks, "diverged"),
        r_out=ptr(out, "r"), q_out=ptr(out, "q"), v_out=ptr(out, "v"), w_out=ptr(out, "w"),
        anchors_out=ptr(out, "anchors"), anchor_valid_out=ptr(out, "anchor_valid"),
        diverged_out=ptr(out, "diverged"),
        gravity=(ctypes.c_double * 3)(*consts.gravity),
        k_contact=consts.k_contact, c_contact=consts.c_contact, v_slip=consts.v_slip,
        max_force=consts.max_contact_force, freeze=consts.divergence_freeze,
        dt_obj=consts.dt_obj, batch=B, n_steps=n_steps, n_sub=consts.n_sub, n_obj=n_obj,
        n_slots=n_slots, s_max=tables.s_max, k_max=tables.k_max,
        stiction=int(consts.stiction), has_diverged=int("diverged" in masks),
        slot_piece=ptr(ints, "slot_piece"), obj_rows=ptr(ints, "obj_rows"),
        n_rows=tables.n_rows, max_piece=tables.max_piece,
        has_reactions=int(tables.has_reactions),
    )
    lib = _library()
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.plant_advance(ctypes.byref(args), _ELEM_BYTES[dtype], stream)
    if err != 0:
        raise RuntimeError(f"plant_advance launch failed with CUDA error {err}")
    launch_count += 1
    return objects.replace(
        r=out["r"], q=out["q"], v=out["v"], w=out["w"],
        anchors=out.get("anchors"),
        anchor_valid=out["anchor_valid"].bool() if consts.stiction else None,
        diverged=out["diverged"].bool() if "diverged" in out else None,
    )


def advance_objects(tables: ContactTables, consts: PlantConstants, frames, objects, params):
    """Advance the objects through ``frames.shape[1] * consts.n_sub``
    substeps (see the module docstring).

    CUDA tensors go to the kernel (float32 or float64, all of one dtype) or
    raise; CPU tensors run the plain version.
    """
    if frames.is_cuda:
        return _advance_objects_cuda(tables, consts, frames, objects, params)
    if frames.device.type != "cpu":
        raise ValueError(f"frames are on {frames.device}: the plant runs on CUDA or the CPU")
    return advance_objects_plain(tables, consts, frames, objects, params)


def smem_bytes(tables, n_sub, dtype):
    """Bytes of dynamic shared memory one block of the kernel takes: the
    objects' state and constants, the outer step's frames and the pieces'
    sums (csrc/plant.cu plant_smem_bytes)."""
    return _library().plant_smem_bytes(tables.n_obj, n_sub, tables.n_rows, _ELEM_BYTES[dtype])


def plant_work(tables, consts, B, n_steps, elem_bytes):
    """(bytes, operations) of one call, for the kernel's bound: each input
    read once and each output written once; the floating-point operations
    each substep needs, counted once per instance (the tray frame: about 130),
    per slot (about 250 under stiction, 205 regularized: frame changes,
    penetration, velocities, forces, torques) and per object (about 330: two
    rotations, the world inertia and its solve, the quaternion update, the
    divergence check), square roots, divisions and sines as one each."""
    n_obj, n_slots = tables.n_obj, tables.n_slots
    n_anchor = n_obj * tables.s_max * tables.k_max if consts.stiction else 0
    state = n_obj * 13 + 2 * n_anchor  # r q v w, anchors
    per_instance = n_steps * FRAME_DIM + n_obj * (1 + 9 + 1 + 3) + 2 * state
    tables_elems = n_slots * (SLOT_GEOM_DIM + 4) + n_obj * (OBJ_DATA_DIM + 2)
    flags = B * 2 * (n_anchor + n_obj)  # contact flags and latch, one byte each, in and out
    nbytes = elem_bytes * (B * per_instance + tables_elems) + flags
    per_slot = 250 if consts.stiction else 205
    per_substep = 130 + n_slots * per_slot + n_obj * 330
    return nbytes, B * n_steps * consts.n_sub * per_substep
