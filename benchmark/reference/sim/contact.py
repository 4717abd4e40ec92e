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

import dataclasses

import numpy as np
import torch

from benchmark.reference.core.math import cross, matvec, quat_integrate, quat_to_rot, skew3

# Kernel limits: one block holds one instance, one thread per slot.
MAX_SLOTS = 256
MAX_OBJECTS = 32
WARP = 32

# Columns of the tables
FRAME_DIM = 24  # R (9, row-major), p, v, w, a, al of the EE at one outer step
SLOT_GEOM_DIM = 18  # point 3, normal 3, tangents 2x3, half extents 2, max depth, vertex 3
OBJ_DATA_DIM = 5  # n_eff, L2 (largest squared vertex lever), nominal CoM in the EE frame 3

_ELEM_BYTES = {torch.float32: 4, torch.float64: 8}

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



def advance_objects(tables: ContactTables, consts: PlantConstants, frames, objects, params):
    """The plain substep loop on any device."""
    return advance_objects_plain(tables, consts, frames, objects, params)
